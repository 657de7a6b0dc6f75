"""Flag fixture: unlocked read-test-write windows on shared state —
the lazy-singleton shape on a module global, and the
`if closed: return` guard shape on an instance flag. Two threads pass
either test together before one writes."""

import threading

_LISTENER = None


def ensure_listener():
    global _LISTENER
    if _LISTENER is None:  # both threads see None...
        _LISTENER = object()  # ...and both install


class Closer:
    def __init__(self):
        self._lock = threading.Lock()
        self._closed = False

    def close(self):
        if self._closed:  # both callers pass...
            return
        self._closed = True  # ...and teardown below runs twice
