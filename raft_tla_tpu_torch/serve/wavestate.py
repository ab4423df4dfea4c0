"""Per-job wave state: preemptible batch waves (the reference's
``serve/wavestate.py``, with its file format).

A job's state in a batched wave is a resumable carry: its frontier
ring, visited table, global-id cursor and depth all ride the job axis
(serve/batch).  This module persists one job's slice of that carry,
with its harvest bookkeeping and trace archives, at every wave
boundary, so:

- a killed ``batch`` run resumes: finished jobs answer from the result
  cache, and the others continue mid-BFS from their persisted carry,
  bit-exact, since every wave step is a deterministic function of the
  carry;
- a long job can yield its lane to a waiting job (``--wave-yield``):
  its carry parks here (or in memory) and the job continues in a later
  wave.

Storage is one ``<cache_key>.wave.npz`` per job under the state
directory, written atomically with the checkpoint chain's integrity
sidecar (resil/ckpt_chain): a torn file from a kill mid-write reads as
"no saved state" (the job restarts), never a crash.  The arrays are
host numpy in the reference's names and dtypes (the table u32 [W,
VCAP], the frontier rows in their storage dtypes, gids int32), so a
file either package writes loads in the other.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from ..resil.ckpt_chain import publish, verify


class WaveStateStore:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key + ".wave.npz")

    def save(self, key: str, arrays: Dict[str, np.ndarray],
             book: Dict):
        data = dict(arrays)
        data["book"] = np.array(json.dumps(book))
        tmp = self._file(key) + ".tmp.npz"
        np.savez(tmp, **data)
        publish(tmp, self._file(key), keep=1)

    def load(self, key: str) -> Optional[Tuple[Dict, Dict]]:
        """(arrays, book) or None — a missing, torn or foreign file is
        a miss (the job restarts from scratch), never an error."""
        path = self._file(key)
        if not os.path.exists(path):
            return None
        ok, why = verify(path)
        if ok is False:
            warnings.warn(
                f"{path}: wave state failed integrity validation "
                f"({why}) — job restarts from scratch", UserWarning,
                stacklevel=2)
            return None
        try:
            z = np.load(path, allow_pickle=False)
            book = json.loads(str(z["book"]))
            arrays = {nm: np.asarray(z[nm]) for nm in z.files
                      if nm != "book"}
            z.close()
        except Exception:
            return None
        if book.get("cache_key") != key:
            return None
        return arrays, book

    def drop(self, key: str):
        for suffix in ("", ".sum"):
            try:
                os.remove(self._file(key) + suffix)
            except OSError:
                pass
