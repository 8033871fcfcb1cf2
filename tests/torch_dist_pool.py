"""A pool of ranks of the port for the multi-rank CPU tests.

``RankPool(world, tmp_dir)`` starts ``world`` processes of
``tests/torch_dist_worker.py``: each imports the port alone (never jax or
``paddle_tpu``), joins the others over gloo through a ``file://`` store
under ``tmp_dir`` (never a fixed port: tests run in parallel) and then runs
the cases of ``tests/torch_dist_cases.py`` it is fed, one pickled line per
case on its stdin, answering one pickled line on its stdout. ``run(case,
**kwargs)`` feeds every rank the same case and returns the ranks' results
in rank order. Nothing here imports jax, so a module that starts a pool
after jax has started forks nothing of it: the ranks are fresh
interpreters.
"""
from __future__ import annotations

import base64
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TIMEOUT_S = 240


def encode(obj) -> bytes:
    return base64.b64encode(pickle.dumps(obj)) + b"\n"


def decode(line: bytes):
    return pickle.loads(base64.b64decode(line.strip()))


class RankPool:
    def __init__(self, world: int, tmp_dir, extra_env=None):
        self.world = world
        store = Path(tmp_dir) / f"store_{world}"
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": f"file://{store}",
            "PADDLE_DISTRI_BACKEND": "gloo",
            "PYTHONPATH": os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]),
            "OMP_NUM_THREADS": "1",
        })
        env.pop("XLA_FLAGS", None)
        env.update(extra_env or {})
        self.procs = []
        for rank in range(world):
            e = dict(env, PADDLE_TRAINER_ID=str(rank))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_dist_worker.py")], env=e,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                cwd=str(ROOT)))
        self._err = [[] for _ in range(world)]
        for p, buf in zip(self.procs, self._err):
            threading.Thread(target=self._drain, args=(p.stderr, buf), daemon=True).start()
        self.run("ready")

    @staticmethod
    def _drain(stream, buf):
        for line in stream:
            buf.append(line.decode(errors="replace"))
            del buf[:-200]

    def run(self, case, **kwargs):
        """Every rank runs ``case(**kwargs)``; their results, in rank order.
        A rank's exception is raised here with its traceback."""
        msg = encode((case, kwargs))
        for p in self.procs:
            p.stdin.write(msg)
            p.stdin.flush()
        out = [None] * self.world

        def read(i):
            out[i] = self.procs[i].stdout.readline()

        threads = [threading.Thread(target=read, args=(i,), daemon=True)
                   for i in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        results = []
        for i, line in enumerate(out):
            if not line:
                raise RuntimeError(f"rank {i} gave no answer to {case!r}; its stderr:\n"
                                   + "".join(self._err[i][-40:]))
            ok, value = decode(line)
            if not ok:
                raise RuntimeError(f"rank {i} failed in {case!r}:\n{value}")
            results.append(value)
        return results

    def close(self):
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
