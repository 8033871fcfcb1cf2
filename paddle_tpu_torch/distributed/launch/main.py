"""The collective launcher: one process per rank
(``paddle_tpu/distributed/launch/main.py``; reference: launch/main.py:18,
controllers/collective.py).

The JAX launcher starts one controller per host. The port starts one
process per rank, as Paddle does: ``--nproc_per_node`` defaults to the
visible cards, and ``--devices`` (``--gpus``) names each rank's card,
repeats allowed (``--devices 0,0,0,0``: four ranks on card 0, which need
``PADDLE_DISTRI_BACKEND=gloo``; the launcher refuses NCCL there). Each rank
gets the env contract (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_MASTER``,
``PADDLE_JOB_ID``, ``PADDLE_LOCAL_RANK``, ``FLAGS_selected_gpus``), its
output goes to ``--log_dir/workerlog.<rank>``, and the launcher exits with
the first failing rank's code after stopping the others. ``--max_restart``
relaunches the whole pod that many times after a failure, as the JAX
launcher's elastic manager does. ``--run_mode ps`` is ROADMAP queue 1 item
13c.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 train.py
    PADDLE_DISTRI_BACKEND=gloo python -m paddle_tpu_torch.distributed.launch \\
        --devices 0,0,0,0 train.py
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional


class Container:
    """One rank's process (reference: launch/job/container.py)."""

    def __init__(self, cmd: List[str], env: dict, log_path: Optional[str] = None):
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_f = None

    def start(self):
        out = None
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            # append: a relaunch keeps the failed attempt's log
            self._log_f = open(self.log_path, "a")
            out = self._log_f
        self.proc = subprocess.Popen(self.cmd, env=self.env, stdout=out,
                                     stderr=subprocess.STDOUT)

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    @property
    def exit_code(self):
        return self.proc.poll() if self.proc else None

    def terminate(self):
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._log_f:
            self._log_f.close()
            self._log_f = None


class Pod:
    """The ranks this node runs (reference: launch/job/pod.py)."""

    def __init__(self):
        self.containers: List[Container] = []

    def add(self, c: Container):
        self.containers.append(c)

    def deploy(self):
        for c in self.containers:
            c.start()

    def watch(self, poll_s: float = 0.2) -> int:
        """0 when every rank exits 0; else the first failing rank's code,
        after stopping the others."""
        try:
            while True:
                codes = [c.exit_code for c in self.containers]
                bad = [code for code in codes if code not in (None, 0)]
                if bad:
                    self.stop()
                    return bad[0]
                if all(code == 0 for code in codes):
                    self.stop()
                    return 0
                time.sleep(poll_s)
        except KeyboardInterrupt:
            self.stop()
            return 1

    def stop(self):
        for c in self.containers:
            c.terminate()


def _visible_cards() -> int:
    import torch

    return torch.cuda.device_count()


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch",
                                description="launch a collective training job, a process "
                                            "per rank")
    p.add_argument("--master", default=None,
                   help="the rendezvous store: host:port (a TCP store node 0's rank 0 "
                        "serves) or file://PATH; a free port of the loopback when one node")
    p.add_argument("--nnodes", type=int, default=int(os.getenv("PADDLE_NNODES", "1")))
    p.add_argument("--rank", type=int, default=int(os.getenv("PADDLE_RANK", "-1")),
                   help="node rank; -1 = 0")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node: the --devices listed, else the visible cards "
                        "(1 without a card)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", "--gpus", dest="devices", default=None,
                   help="each rank's card, comma-separated; repeats share a card")
    p.add_argument("--run_mode", default="collective", choices=["collective", "ps"])
    p.add_argument("--max_restart", type=int,
                   default=int(os.getenv("PADDLE_ELASTIC_MAX_RESTART", "0")),
                   help="relaunch the pod up to this many times after a failure")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _devices(args) -> List[str]:
    if args.devices:
        devs = [d.strip() for d in args.devices.split(",") if d.strip()]
        n = args.nproc_per_node or len(devs)
        if n != len(devs):
            raise SystemExit(f"launch: --nproc_per_node {n} but --devices names {len(devs)}")
        return devs
    n = args.nproc_per_node or max(1, _visible_cards())
    return [str(i) for i in range(n)]


def _check_backend(devs: List[str]) -> None:
    backend = os.getenv("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if backend == "gloo" or len(set(devs)) == len(devs):
        return
    if backend == "nccl" or _visible_cards() > 0:
        raise SystemExit(
            f"launch: --devices {','.join(devs)} puts ranks on one card, where NCCL refuses "
            "two ranks ('Duplicate GPU detected'); set PADDLE_DISTRI_BACKEND=gloo")


def _build_pod(args, devs: List[str], master: str) -> Pod:
    """reference: controllers/collective.py:32 build_pod."""
    from ..utils import find_free_ports

    pod = Pod()
    nproc = len(devs)
    node_rank = max(args.rank, 0)
    world = args.nnodes * nproc
    host = "127.0.0.1"
    ports = sorted(find_free_ports(nproc) or [])
    endpoints = []
    for node in range(args.nnodes):
        for i in range(nproc):
            if node == node_rank and len(ports) == nproc:
                endpoints.append(f"{host}:{ports[i]}")
            else:
                endpoints.append(f"node{node}:{6170 + i}")
    for local, dev in enumerate(devs):
        rank = node_rank * nproc + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_MASTER": master,
            "PADDLE_JOB_ID": args.job_id,
            "PADDLE_LOCAL_RANK": str(local),
            "PADDLE_LOCAL_SIZE": str(nproc),
            "FLAGS_selected_gpus": dev,
        })
        cmd = [sys.executable, "-u", args.training_script] + list(args.training_script_args or [])
        pod.add(Container(cmd, env, os.path.join(args.log_dir, f"workerlog.{rank}")))
    return pod


def launch(argv=None) -> int:
    args = _parse_args(argv)
    if args.run_mode == "ps":
        raise NotImplementedError(
            "launch --run_mode ps (parameter servers) is not ported yet (ROADMAP, open items, "
            "queue 1 item 13c)"
        )
    devs = _devices(args)
    _check_backend(devs)
    if args.master:
        master = args.master
    elif args.nnodes == 1:
        from ..utils import find_free_ports

        master = f"127.0.0.1:{sorted(find_free_ports(1))[0]}"
    else:
        raise SystemExit("launch: --nnodes > 1 needs --master host:port")
    attempts = args.max_restart + 1
    code = 1
    for attempt in range(attempts):
        if attempt:
            print(f"launch: rank failed with code {code}; relaunching the pod "
                  f"({attempt} of {args.max_restart})", flush=True)
            if master.startswith("file://") and os.path.exists(master[len("file://"):]):
                os.remove(master[len("file://"):])
        pod = _build_pod(args, devs, master)
        pod.deploy()

        def _sig(*_):
            pod.stop()
            sys.exit(1)

        signal.signal(signal.SIGTERM, _sig)
        code = pod.watch()
        if code == 0:
            return 0
    return code


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
