"""torchlint fixture (MUST FLAG donation-aliasing): restored tensors rebound into a
captured state, graph outputs read after the next replay. chip_smoke.py replays it."""


def _stub():
    return None


def resume_and_step(ckpt, graph, state):
    restored = ckpt.restore(state)
    state.params = restored["params"]  # the graph still reads the old tensor
    return graph.replay()


def double_use(step, state):
    step.replay()
    metrics = step.replay()  # valid until the next replay ...
    step.replay()
    return metrics, state  # ... read after it


def quantized_ingest_stale_read(step):
    """The ingest's outputs hold the ring's codec stats: a view kept from
    one replay is read after the next one rewrote it."""
    step.replay()
    stats = step.replay()["quant"]  # a view of this replay's output ...
    return step.replay(), stats  # ... rewritten by this one


def ring_enqueue_stale_gather(enqueue, slots):
    """Every replay returns the same output tensors: collected in a loop,
    each entry reads the last replay's values."""
    outs = []
    for _ in slots:
        outs.append(enqueue.replay())  # the same tensors every time
    return outs


def ring_enqueue_restored(ckpt, graph, ring):
    """Device-ring resume: the restored storage rebound into the ring the
    enqueue graph writes, where it must be copied in."""
    restored = ckpt.restore(ring)
    # the enqueue graph was captured over ring.storage: a rebinding leaves
    # it writing the old tensor
    ring.storage = restored["storage"]
    return graph.replay()
