"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the program's
set-up (from the weights on) and the window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
