"""Near miss: the same shapes as publish_aliasing_flag.py made safe —
snapshots (`.clone()` / `torch.tensor`) at every channel boundary, a
per-iteration allocation instead of a republished slot, and the consumer
copying before `release`."""

import torch


class BlockProducer:
    def __init__(self, queue):
        self._queue = queue
        self._slot = torch.zeros((8, 4), dtype=torch.float32)

    def run(self):
        while True:
            self._slot.fill_(1.0)
            self._queue.put({"obs": self._slot.clone()})
            self._queue.put(self._slot[:4].clone())


def publish_loop(publisher, n):
    for v in range(n):
        buf = torch.full((4,), float(v))  # fresh every pass
        publisher.publish(buf, version=v)


def drain(queue, update, params):
    while True:
        block = queue.get()
        arrays = {k: torch.tensor(v) for k, v in block.arrays.items()}
        queue.release(block)  # safe: arrays are copies
        params = update(params, arrays)
