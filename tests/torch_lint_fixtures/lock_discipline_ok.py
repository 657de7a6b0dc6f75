"""Near miss: the same shapes as lock_discipline_flag.py made safe —
global mutations under a module lock, and the single-writer counter
carrying an audited `# torchlint: thread-owned=<role>` annotation."""

import threading

_OPEN_LOCK = threading.Lock()
_OPEN_SPANS = []


class SpanService:
    def __init__(self):
        # torchlint: thread-owned=collector (single writer: only this
        # service's own thread bumps the counter; readers tolerate a
        # one-block-stale value)
        self.blocks = 0
        self._thread = threading.Thread(
            target=self._run, name="collector", daemon=True
        )

    def start(self):
        self._thread.start()

    def enter(self, name):
        with _OPEN_LOCK:
            _OPEN_SPANS.append(name)

    def exit(self):
        with _OPEN_LOCK:
            _OPEN_SPANS.pop()

    def _run(self):
        while True:
            self.enter("step")
            self.blocks += 1  # annotated single-writer counter
            self.exit()
