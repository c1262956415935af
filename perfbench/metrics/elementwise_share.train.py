"""elementwise_share.train — elementwise and copy kernels' share of the
device's busy time in the traced steps (the families ``elementwise`` and
``copy_cat_memcpy`` of ``harness/trace.py``'s ``FAMILIES``), in percent.
Source: the device trace."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("mode") != "train" or not tr or not tr["busy_s"]:
        return None
    fam = tr["families"]
    return 100.0 * (fam.get("elementwise", 0.0) + fam.get("copy_cat_memcpy", 0.0)) \
        / sum(fam.values())
