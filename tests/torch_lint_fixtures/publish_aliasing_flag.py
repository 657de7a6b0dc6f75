"""Flag fixture: views of recycled storage crossing a thread channel, both
sides of the zero-copy race. Producer side: a preallocated (pinned) slot,
and a view of it, handed to `.put()`/`.publish()` without a snapshot.
Consumer side: `torch.from_numpy` aliases a block that is `release`d back
to its slot pool in the same scope."""

import torch


class BlockProducer:
    def __init__(self, queue):
        self._queue = queue
        self._slot = torch.zeros((8, 4), dtype=torch.float32)

    def run(self):
        while True:
            self._slot.fill_(1.0)
            self._queue.put({"obs": self._slot})  # slot, not snapshot
            self._queue.put(self._slot[:4])  # view of the slot


def publish_loop(publisher, n):
    buf = torch.zeros((4,), dtype=torch.float32)  # allocated once...
    for v in range(n):
        buf.fill_(v)
        publisher.publish(buf, version=v)  # ...republished every pass


def drain(queue, update, params):
    while True:
        block = queue.get()
        arrays = {k: torch.from_numpy(v) for k, v in block.arrays.items()}
        queue.release(block)  # slot recycles under the zero-copy views
        params = update(params, arrays)
