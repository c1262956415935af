"""decode_attention_roofline — the decode-attention kernel in the traced
ticks: its least time (the live keys and values read once, q read and the
output written once) over its device time (kernels ``decode_*``), in
percent. Source: the device trace and the per-tick counter of cached
keys."""
from perfbench.harness import costs


def read(rec):
    tr = rec.get("trace")
    if rec.get("mode") != "serve" or not tr or not tr["kv"]:
        return None
    dev_s = tr["families"].get("decode_attention", 0.0)
    if not dev_s:
        return None
    cfg, B = rec["config"], rec["traffic"]["max_batch"]
    bound = 0.0
    for kv in tr["kv"]:
        c = costs.decode_attention_cost(cfg, rec["elem"], B, kv)
        bound += cfg["num_hidden_layers"] * costs.bound_s(c["bytes"], c["flops"])
    return 100.0 * bound / dev_s
