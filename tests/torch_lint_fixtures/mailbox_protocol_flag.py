"""Flag fixture (MUST FLAG mailbox-protocol, all four shapes): a
non-atomic publish of the consumed path, an atomic publish missing
fsync with a collision-prone shared tmp name, a torn-intolerant
consumer, and a global (non-per-peer) version clock. Parsed only —
never imported."""

import os

import numpy as np


def snapshot_file(mailbox_dir, who):
    return os.path.join(mailbox_dir, f"host{who}", "params.npz")


def publish_direct(mailbox_dir, who, payload):
    path = snapshot_file(mailbox_dir, who)
    with open(path, "wb") as f:  # torn under SIGKILL: readers see half
        np.savez(f, **payload)
    return path


def publish_shared_tmp(mailbox_dir, who, payload):
    path = snapshot_file(mailbox_dir, who)
    tmp = os.path.join(mailbox_dir, "pending.tmp")  # shared across ranks
    with open(tmp, "wb") as f:  # and no fsync before the rename
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def consume_intolerant(mailbox_dir, who):
    path = snapshot_file(mailbox_dir, who)
    try:
        with np.load(path) as z:  # truncated npz raises BadZipFile
            return {k: z[k] for k in z.files}
    except OSError:
        return None


def consume_global_clock(mailbox_dir, schedule):
    newest = -1  # ONE clock for every peer: fast peers mute slow ones
    out = []
    for peer in schedule:
        snap = consume_intolerant(mailbox_dir, peer)
        if snap is None:
            continue
        version = int(snap["version"])
        if version > newest:
            newest = version
            out.append((peer, version))
    return out
