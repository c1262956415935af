"""guard_launches_per_request.serve — guard kernels (``ops.LAUNCHES``:
guard copy and the MAC kernels) launched in the window, over the calls
answered in it. Source: the program's counter."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["answered"]:
        return None
    return rec["guard_launches"] / rec["answered"]
