"""Near miss: the same shapes as check_then_act_flag.py made safe —
double-checked locking for the lazy singleton (the unlocked fast-path
test is fine because the WRITE re-tests under the lock), and
test-and-set under the instance lock for the close guard."""

import threading

_LOCK = threading.Lock()
_LISTENER = None


def ensure_listener():
    global _LISTENER
    if _LISTENER is None:  # unlocked fast path...
        with _LOCK:
            if _LISTENER is None:  # ...re-tested under the lock
                _LISTENER = object()


class Closer:
    def __init__(self):
        self._lock = threading.Lock()
        self._closed = False

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
