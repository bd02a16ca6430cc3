"""Peak memory allocated on the card over the training window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB."""


def read(run):
    if run.mode != "train" or not run.peak_bytes_window:
        return None
    return run.peak_bytes_window / 1e9
