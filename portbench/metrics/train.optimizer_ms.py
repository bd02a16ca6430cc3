"""Device ms of Adam's update in one replay of the train step: the median
over the traced epoch's replays of the program's stamps
``train_step.optimizer`` to ``train_step.end``, from ``spans`` in its
``trace_rank0.launches.json``."""


def read(run):
    ms = ((run.launches or {}).get("spans") or {}).get("ms") or {}
    return ms.get("optimizer") if run.mode == "train" else None
