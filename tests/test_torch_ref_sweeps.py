"""The JAX package's own op sweeps, run against the port on the CPU: the
sources of ``tests/test_op_numeric_sweep.py``, ``test_op_numeric_sweep2.py``
and ``test_nn_surface2.py`` are loaded with ``paddle`` (and ``F``, ``nn``)
bound to ``paddle_tpu_torch``, and their parametrised cases run here, at
their own tolerances, against numpy and finite differences as they hold the
JAX package. The reference files are not edited; two cases differ here:

- ``test_manipulation_forward[cumsum]`` holds at rtol 1e-5, not 1e-6: ATen
  sums the prefix in another order than numpy (2.1e-6 relative, 3e-8
  absolute, on float32 values near 1);
- ``test_converter_group_shape_mismatch_raises`` imports
  ``distributed.auto_parallel``, which the port does not have yet (ROADMAP
  queue 1 item 13): expected to fail with ModuleNotFoundError.
"""
import pathlib
import types

import pytest

import paddle_tpu_torch as tp

ROOT = pathlib.Path(__file__).resolve().parent

CUMSUM_RTOL = 1e-5

# file -> [(text of the reference, text it runs with here)]
EDITS = {
    "test_op_numeric_sweep.py": [(
        "    np.testing.assert_allclose(out, np.asarray(ref(x_np)), rtol=1e-6)\n",
        "    np.testing.assert_allclose(out, np.asarray(ref(x_np)),\n"
        "                               rtol=CUMSUM_RTOL if name == 'cumsum' else 1e-6)\n",
    )],
    "test_op_numeric_sweep2.py": [],
    "test_nn_surface2.py": [],
}
IMPORTS = [
    ("import paddle_tpu as paddle\n", "import paddle_tpu_torch as paddle\n"),
    ("import paddle_tpu.nn.functional as F\n", "import paddle_tpu_torch.nn.functional as F\n"),
    ("from paddle_tpu import nn\n", "from paddle_tpu_torch import nn\n"),
    ("from paddle_tpu.distributed", "from paddle_tpu_torch.distributed"),
]
XFAIL = {
    ("test_op_numeric_sweep2.py", "test_converter_group_shape_mismatch_raises"): pytest.mark.xfail(
        raises=ModuleNotFoundError, strict=True,
        reason="paddle.distributed.auto_parallel is not ported yet (ROADMAP queue 1 item 13)"),
}


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _load(name):
    """The reference test module ``name`` run with the port as ``paddle``."""
    text = (ROOT / name).read_text()
    for old, new in IMPORTS + EDITS[name]:
        if old in text:
            text = text.replace(old, new)
        else:
            assert (old, new) in IMPORTS, f"{name}: the edited text is gone: {old!r}"
    assert "paddle_tpu." not in text.replace("paddle_tpu_torch", ""), name
    module = types.ModuleType(f"port_{name[:-3]}")
    module.__file__ = str(ROOT / name)
    module.CUMSUM_RTOL = CUMSUM_RTOL
    exec(compile(text, str(ROOT / name), "exec"), module.__dict__)
    return module


def _collect():
    """Every test function and class of the three files, as
    ``test_<file>__<name>`` and ``Test_<file>__<name>``."""
    out = {}
    for name in EDITS:
        module = _load(name)
        for attr, obj in vars(module).items():
            if attr.startswith("test_") and callable(obj):
                mark = XFAIL.get((name, attr))
                out[f"test_{name[5:-3]}__{attr[5:]}"] = mark(obj) if mark else obj
            elif attr.startswith("Test") and isinstance(obj, type):
                out[f"Test_{name[5:-3]}__{attr[4:]}"] = obj
    return out


globals().update(_collect())


def test_every_reference_case_is_collected():
    names = [n for n in globals() if "__" in n and n.lower().startswith("test_")]
    # the two sweeps' test functions and test_nn_surface2.py's test classes
    assert len(names) == 5 + 13 + 6
