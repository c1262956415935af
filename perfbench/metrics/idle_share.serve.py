"""idle_share.serve — 1 − the union of the device's kernel, copy and fill
intervals over the traced sub-window, in percent. Source: the device
trace."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("mode") != "serve" or not tr or not tr["wall_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
