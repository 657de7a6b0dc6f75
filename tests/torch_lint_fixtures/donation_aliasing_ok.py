"""torchlint fixture (near miss, must NOT flag): the restored values copied
into the captured tensors, and every output snapshot before the next
replay. Parsed by the tests; chip_smoke.py replays resume_and_step on the
card."""


def resume_and_step(ckpt, graph, state):
    restored = ckpt.restore(state)
    state.params.copy_(restored["params"])  # in place: the graph sees it
    return graph.replay()


def double_use(step, state):
    metrics = {k: v.clone() for k, v in step.replay().items()}
    step.replay()
    return metrics, state


def quantized_ingest_fresh_read(step):
    stats = step.replay()["quant"].clone()
    return step.replay(), stats


def ring_enqueue_collected(enqueue, slots):
    return [{k: v.clone() for k, v in enqueue.replay().items()} for _ in slots]


def ring_enqueue_restored(ckpt, graph, ring):
    restored = ckpt.restore(ring)
    ring.storage.copy_(restored["storage"])
    return graph.replay()
