"""The port's launcher, ``python -m paddle_tpu_torch.distributed.launch``, on
the CPU: one process per rank with Paddle's env contract, a failing rank
ending the job with its code, ``--max_restart`` relaunching the pod, the
refusals (NCCL on a shared card, the PS mode of item 13c), and
``paddle_tpu_torch/examples/train_gpt.py --dp 2 --mp 2`` under it, whose
``generate()`` tokens equal one process's. The ranks import the port alone
and join over gloo."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from paddle_tpu_torch.distributed.launch import launch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "paddle_tpu_torch" / "examples" / "train_gpt.py"
ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS",
            "PADDLE_CURRENT_ENDPOINT", "PADDLE_MASTER", "PADDLE_JOB_ID", "PADDLE_LOCAL_RANK",
            "FLAGS_selected_gpus", "PADDLE_DISTRI_BACKEND")


def _launch(args, tmp_path, timeout=240, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT), PADDLE_DISTRI_BACKEND="gloo",
                OMP_NUM_THREADS="1", **env)
    full.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--log_dir", str(tmp_path / "log"), *args]
    return subprocess.run(cmd, cwd=ROOT, env=full, capture_output=True, text=True,
                          timeout=timeout)


def _log(tmp_path, rank):
    return (tmp_path / "log" / f"workerlog.{rank}").read_text()


def _script(tmp_path, body, name="job.py"):
    path = tmp_path / name
    path.write_text(body)
    return str(path)


def test_env_contract_per_rank(tmp_path):
    """Each rank gets its id, the world, the endpoints (its own among them),
    the store, the job id, its card (--devices may repeat one) and the
    backend; its output goes to log_dir/workerlog.<rank>."""
    job = _script(tmp_path, "import json, os\n"
                            f"print(json.dumps({{k: os.environ.get(k) for k in {ENV_KEYS!r}}}))\n")
    proc = _launch(["--devices", "0,0,0", "--job_id", "envjob", job], tmp_path)
    assert proc.returncode == 0, proc.stderr
    envs = [json.loads(_log(tmp_path, r).strip().splitlines()[-1]) for r in range(3)]
    eps = envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 3 and len(set(eps)) == 3
    for r, e in enumerate(envs):
        assert e["PADDLE_TRAINER_ID"] == str(r) and e["PADDLE_TRAINERS_NUM"] == "3"
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert e["PADDLE_TRAINER_ENDPOINTS"] == envs[0]["PADDLE_TRAINER_ENDPOINTS"]
        assert e["PADDLE_MASTER"] == envs[0]["PADDLE_MASTER"]
        assert e["PADDLE_JOB_ID"] == "envjob" and e["PADDLE_LOCAL_RANK"] == str(r)
        assert e["FLAGS_selected_gpus"] == "0" and e["PADDLE_DISTRI_BACKEND"] == "gloo"


def test_a_failing_rank_ends_the_job_with_its_code(tmp_path):
    """Rank 1 exits 3 while rank 0 would sleep a minute: the launcher stops
    rank 0 and exits 3 at once."""
    job = _script(tmp_path, "import os, sys, time\n"
                            "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
                            "    sys.exit(3)\n"
                            "time.sleep(60)\n")
    t0 = time.perf_counter()
    proc = _launch(["--nproc_per_node", "2", job], tmp_path)
    assert proc.returncode == 3
    assert time.perf_counter() - t0 < 30


def test_max_restart_relaunches_the_pod(tmp_path):
    """The first attempt fails on rank 0; ``--max_restart 1`` relaunches
    both ranks, which then succeed; without it the job fails."""
    marker = tmp_path / "tried"
    job = _script(tmp_path, "import os, sys\n"
                            f"m = {str(marker)!r}\n"
                            "if os.environ['PADDLE_TRAINER_ID'] == '0' and not os.path.exists(m):\n"
                            "    open(m, 'w').close()\n"
                            "    sys.exit(5)\n")
    assert _launch(["--nproc_per_node", "2", job], tmp_path).returncode == 5
    marker.unlink()
    proc = _launch(["--nproc_per_node", "2", "--max_restart", "1", job], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "relaunching the pod" in proc.stdout


def test_refusals(monkeypatch):
    """NCCL on a card two ranks share is refused before any rank starts;
    the PS mode waits for item 13c."""
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(SystemExit, match="Duplicate GPU"):
        launch(["--devices", "0,0", "job.py"])
    with pytest.raises(NotImplementedError, match="queue 1 item 13c"):
        launch(["--run_mode", "ps", "job.py"])


def _generated(text):
    lines = [line for line in text.splitlines() if line.startswith("generated ids:")]
    assert lines, text[-2000:]
    return json.loads(lines[-1].split(":", 1)[1])


def test_train_gpt_example_under_the_launcher_generates_one_process_tokens(tmp_path):
    """examples/train_gpt.py --dp 2 --mp 2 as 4 ranks on the CPU: every
    rank's greedy tokens after training equal one process's (the hybrid
    model is built from the same seed: each weight is made whole, then cut)."""
    args = ["--steps", "3", "--seq", "32", "--device", "cpu"]
    one = subprocess.run([sys.executable, str(EXAMPLE), *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr
    want = _generated(one.stdout)
    proc = _launch(["--nproc_per_node", "4", str(EXAMPLE), "--dp", "2", "--mp", "2", *args],
                   tmp_path)
    assert proc.returncode == 0, proc.stderr + _log(tmp_path, 0)[-3000:]
    for r in range(4):
        assert _generated(_log(tmp_path, r)) == want
