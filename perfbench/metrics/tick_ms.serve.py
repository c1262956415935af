"""tick_ms.serve — the window's time over the engine ticks run in it
(``ServingEngine.ticks``). Source: the program's counter and the host
clock."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["ticks"]:
        return None
    return 1e3 * rec["window_s"] / rec["ticks"]
