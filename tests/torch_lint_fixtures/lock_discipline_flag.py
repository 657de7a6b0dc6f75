"""Flag fixture: compound writes to cross-thread shared state with no
lock held — the PR 6 open-span-stack bug shape, twice: a module-global
stack mutated from service methods that run on actor threads, and a
threaded class whose loop bumps a shared counter unlocked."""

import threading

_OPEN_SPANS = []  # shared by every service thread


class SpanService:
    def __init__(self):
        self.blocks = 0
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def enter(self, name):
        _OPEN_SPANS.append(name)  # interleaved push from actor threads

    def exit(self):
        _OPEN_SPANS.pop()  # ...pops another thread's entry

    def _run(self):
        while True:
            self.enter("step")
            self.blocks += 1  # unlocked read-modify-write
            self.exit()
