"""Device ms of the forward in one replay of the train step: the median over
the traced epoch's replays of the program's stamps ``train_step.forward`` to
``train_step.backward`` (the card's globaltimer), from ``spans`` in its
``trace_rank0.launches.json``."""


def read(run):
    ms = ((run.launches or {}).get("spans") or {}).get("ms") or {}
    return ms.get("forward") if run.mode == "train" else None
