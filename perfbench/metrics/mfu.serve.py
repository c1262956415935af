"""mfu.serve — model FLOPs of every token the decode step processed in the
window (prompt tokens fed and tokens generated: 2 per active parameter
without the input embedding, top-k experts only, and attention over each
token's live positions, each slot's by the family's ``attn_flops_token``),
over the window, at the bf16 peak of 989 TFLOP/s, in percent. Source: the
benchmark's per-tick counter of live slots and each one's cached keys."""
from perfbench.harness import costs


def read(rec):
    if rec.get("mode") != "serve" or not rec["live"]:
        return None
    cfg = rec["config"]
    attn = sum(costs.attn_flops_token(cfg, k) for tick in costs.tick_slots(rec)
               for k in tick)
    flops = 2.0 * costs.params_no_embed(cfg, True) * sum(rec["live"]) + attn
    return 100.0 * flops / rec["window_s"] / costs.PEAK_BF16
