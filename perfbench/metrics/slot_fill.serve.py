"""slot_fill.serve — live slots per tick over ``max_batch``, averaged over
the window's ticks, in percent. Source: the benchmark's wrapper on the
engine's ``sample`` (a counter)."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["live"]:
        return None
    return 100.0 * sum(rec["live"]) / (len(rec["live"]) * rec["traffic"]["max_batch"])
