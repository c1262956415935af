"""flash_attention_roofline — flash attention's forward and backward
kernels in the traced steps: the least time of every call they made
(``ops.LAUNCHES``; a rematerialised layer calls the forward twice; each
call's inputs read once and outputs written once, 4·Dh·H FLOPs a causal
pair forward and 10·Dh·H backward) over their device time (kernels
``flash_*``), in percent. Source: the device trace and the program's
launch counter."""
from perfbench.harness import costs


def read(rec):
    tr = rec.get("trace")
    if rec.get("mode") != "train" or not tr:
        return None
    dev_s = tr["families"].get("flash_attention", 0.0) \
        + tr["families"].get("flash_attention_bwd", 0.0)
    n_fwd = tr["launches"].get("flash_attention", 0)
    n_bwd = tr["launches"].get("flash_attention_bwd", 0)
    if not dev_s or not (n_fwd or n_bwd):
        return None
    cfg, mix, e = rec["config"], rec["traffic"], rec["elem"]
    f = costs.flash_fwd_cost(cfg, e, mix["micro"], mix["seq_len"])
    b = costs.flash_bwd_cost(cfg, e, mix["micro"], mix["seq_len"])
    bound = n_fwd * costs.bound_s(f["bytes"], f["flops"]) \
        + n_bwd * costs.bound_s(b["bytes"], b["flops"])
    return 100.0 * bound / dev_s
