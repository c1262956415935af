"""mfu.train — model FLOPs of the window's steps (6·N·T with N without the
input embedding, and causal attention at three times its forward) over
the window's time, at 989 TFLOP/s, in percent. Source: the host clock and
the steps counted."""
from perfbench.harness import costs


def read(rec):
    if rec.get("mode") != "train" or not rec["steps"]:
        return None
    mix = rec["traffic"]
    flops = costs.train_step_flops(rec["config"], mix["global_batch"], mix["seq_len"])
    return 100.0 * flops * rec["steps"] / rec["window_s"] / costs.PEAK_BF16
