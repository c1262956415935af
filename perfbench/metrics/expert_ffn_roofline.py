"""expert_ffn_roofline — the three expert ``bmm``s of every MoE layer in
the traced ticks: their least time (each operand read once, each result
written once: the experts' weights dominate) over their device time (the
device time under ``aten::bmm``, in ticks traced with the host's
operators), in percent. Each decode step gives every
expert ``max_batch`` rows (its capacity covers every token). Source: the
device trace."""
from perfbench.harness import costs


def read(rec):
    tr = (rec.get("trace") or {}).get("ops")
    if rec.get("mode") != "serve" or not tr or not tr["ticks"]:
        return None
    dev_s = tr["host_op_device_s"].get("aten::bmm", 0.0)
    cfg = rec["config"]
    if not dev_s or not cfg.get("num_local_experts"):
        return None
    c = costs.expert_bmm_cost(cfg, rec["elem"], rec["traffic"]["max_batch"])
    bound = tr["ticks"] * cfg["num_hidden_layers"] * costs.bound_s(c["bytes"], c["flops"])
    return 100.0 * bound / dev_s
