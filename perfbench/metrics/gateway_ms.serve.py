"""gateway_ms.serve — the gateway's share of a call: the mean, over the
calls answered in the window, of the client's call time minus the time
inside the service handler (seal, route, verify, transport and wake-ups on
both sides). Source: the benchmark's own spans (host clock)."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["answered"]:
        return None
    return 1e3 * rec["gateway_s"] / rec["answered"]
