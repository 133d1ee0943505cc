"""peak_mem_gb: the CUDA allocator's peak over the whole run, set-up
included, in 1e9 bytes (torch.cuda.max_memory_allocated)."""


def read(t):
    return t.memory_peak_bytes / 1e9 if t.memory_peak_bytes else None
