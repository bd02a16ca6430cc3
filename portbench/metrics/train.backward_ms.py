"""Device ms of the backward in one replay of the train step (the gradient
all-reduce included under a mesh): the median over the traced epoch's
replays of the program's stamps ``train_step.backward`` to
``train_step.optimizer``, from ``spans`` in its ``trace_rank0.launches.json``."""


def read(run):
    ms = ((run.launches or {}).get("spans") or {}).get("ms") or {}
    return ms.get("backward") if run.mode == "train" else None
