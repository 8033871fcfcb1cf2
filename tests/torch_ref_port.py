"""Load a JAX-package test file with ``paddle`` bound to the port.

The ops-plane test files of the JAX package (``test_sentinel.py``,
``test_diag_server.py``, ``test_attribution.py``, ``test_observability.py``)
drive the public surface: flags, the sentinel, the diagnostics server, the
registry, models and optimizers. ``load`` runs a file's source with its
``paddle_tpu`` imports pointing at ``paddle_tpu_torch`` (and the listed
edits, each of which must still match the reference text); ``collect``
returns its tests and fixtures under new names, so a port test file can
take them into its namespace and pytest runs them against the port at the
reference's own assertions. The reference files are not edited.
"""
import pathlib
import types

ROOT = pathlib.Path(__file__).resolve().parent

IMPORTS = [
    ("import paddle_tpu as paddle\n", "import paddle_tpu_torch as paddle\n"),
    ("import paddle_tpu.", "import paddle_tpu_torch."),
    ("from paddle_tpu.", "from paddle_tpu_torch."),
    ("from paddle_tpu import", "from paddle_tpu_torch import"),
]


def load(name, edits=()):
    text = (ROOT / name).read_text()
    for old, new in edits:
        assert old in text, f"{name}: the edited text is gone: {old!r}"
        text = text.replace(old, new)
    for old, new in IMPORTS:
        text = text.replace(old, new)
    assert "paddle_tpu." not in text.replace("paddle_tpu_torch", ""), name
    module = types.ModuleType(f"port_{name[:-3]}")
    module.__file__ = str(ROOT / name)
    exec(compile(text, str(ROOT / name), "exec"), module.__dict__)
    return module


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction"))


def collect(module, prefix, skip=()):
    """``{name: object}`` of the module's tests (as ``test_<prefix>__<name>``)
    and fixtures (under their own names), leaving out the tests in
    ``skip``."""
    out = {}
    for attr, obj in vars(module).items():
        if attr.startswith("test_") and callable(obj) and not _is_fixture(obj):
            if attr[5:] not in skip:
                out[f"test_{prefix}__{attr[5:]}"] = obj
        elif _is_fixture(obj):
            out[attr] = obj
    return out
