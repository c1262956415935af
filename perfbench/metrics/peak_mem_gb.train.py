"""peak_mem_gb.train — ``torch.cuda.max_memory_allocated`` of the run
before the reference, in GB. Source: the program's allocator (a
counter)."""


def read(rec):
    if rec.get("mode") != "train" or not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 1e9
