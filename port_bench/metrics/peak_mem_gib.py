"""peak_mem_gib (end to end, read by the harness from the caching
allocator): the most device memory held for tensors over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
