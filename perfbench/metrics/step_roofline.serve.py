"""step_roofline.serve — the ticks' least time over the window, in
percent: each tick's bound is the larger of (its weights read once, every
expert's, and its live KV cache read once) over 3.35 TB/s and its tokens'
model FLOPs over 989 TFLOP/s, from each live slot's cached keys. Source:
the per-tick counter and the host clock."""
from perfbench.harness import costs


def read(rec):
    if rec.get("mode") != "serve" or not rec["live"]:
        return None
    cfg, B = rec["config"], rec["traffic"]["max_batch"]
    bound = sum(costs.decode_tick_bound_s(cfg, rec["elem"], B, live, kv)
                for live, kv in zip(rec["live"], costs.tick_slots(rec)))
    return 100.0 * bound / rec["window_s"]
