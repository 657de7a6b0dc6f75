"""Near miss: the mailbox_protocol_flag.py shapes made safe — a
pid-unique same-directory tmp, write -> fsync -> rename, torn-read
tolerance covering the real npz exception set, and per-peer version
clocks. Parsed only — never imported."""

import os
import zipfile

import numpy as np


def snapshot_file(mailbox_dir, who):
    return os.path.join(mailbox_dir, f"host{who}", "params.npz")


def publish_atomic(mailbox_dir, who, payload):
    path = snapshot_file(mailbox_dir, who)
    tmp = f"{path}.tmp.{os.getpid()}"  # process-unique, same directory
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())  # data durable BEFORE the rename is
    os.replace(tmp, path)
    return path


def consume_tolerant(mailbox_dir, who):
    path = snapshot_file(mailbox_dir, who)
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None  # torn reads retry next poll, never fatal


def consume_per_peer_clock(mailbox_dir, schedule):
    seen = {}  # newest version PER RANK: a slow peer's news still lands
    out = []
    for peer in schedule:
        snap = consume_tolerant(mailbox_dir, peer)
        if snap is None:
            continue
        version = int(snap["version"])
        if version > seen.get(peer, -1):
            seen[peer] = version
            out.append((peer, version))
    return out
