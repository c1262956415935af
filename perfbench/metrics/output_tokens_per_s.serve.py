"""output_tokens_per_s.serve — generated tokens of the verified responses
that ended in the window, over the window: the whole window's rate, as the
serve cell measured it end to end before the host's drift between runs
made it too noisy for a bound there. Source: the host clock."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["window_s"]:
        return None
    return rec["output_tokens"] / rec["window_s"]
