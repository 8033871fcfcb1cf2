"""The port's serve-probe CLI on the CPU: ``python -m
paddle_tpu_torch.tools.serve_probe --device cpu`` runs the six scenarios of
the JAX package's ``tools/serve_probe.py`` (parity, faults, storm, sigterm,
overload, wedge) on its tiny GPT, prints one JSON line each and ``ALL
SCENARIOS PASSED``, exits 0, and loads neither jax nor ``paddle_tpu``. One
intra-op thread: the tiny model runs ~3 s so, slower with more.
"""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIOS = ["parity", "faults/p=0.2", "storm/decode", "sigterm-drain", "overload/2x",
             "wedge/supervisor"]


def test_serve_probe_cli_passes_every_scenario_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    code = ("import runpy, sys\n"
            "sys.argv = ['serve_probe', '--device', 'cpu', '--requests', '6', '--max-new', '8']\n"
            "try:\n"
            "    runpy.run_module('paddle_tpu_torch.tools.serve_probe', run_name='__main__')\n"
            "finally:\n"
            "    print('loaded', sorted(n for n in sys.modules\n"
            "                           if n.split('.')[0] in ('jax', 'paddle_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    lines = proc.stdout.splitlines()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert lines[-1] == "loaded []"
    assert lines[-2] == "ALL SCENARIOS PASSED"
    results = [json.loads(line) for line in lines[:-2]]
    assert [r["scenario"] for r in results] == SCENARIOS
    assert all(r["ok"] for r in results)
    assert results[0]["completed"] == 6 and results[2]["demotions"] >= 1


def test_serve_probe_refuses_the_card_when_there_is_none():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.serve_probe"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "ALL SCENARIOS PASSED" not in proc.stdout
