"""The seven core flags the JAX package defines and reads nowhere
(``paddle_tpu/core/flags.py:223,703-716``), in the port: each one's default
equals the JAX package's, ``set_flags`` accepts another value and
``get_flags`` returns it, and ``describe_flags`` documents it. Nothing
reads them in either package, so setting one changes no behaviour.
"""
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

CORE_FLAGS = {
    "FLAGS_use_standalone_executor": False,
    "FLAGS_max_inplace_grad_add": 8,
    "FLAGS_init_allocated_mem": True,
    "FLAGS_allocator_strategy": "naive_best_fit",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.5,
    "FLAGS_cudnn_deterministic": True,
    "FLAGS_embedding_deterministic": 1,
}


@pytest.mark.parametrize("name", sorted(CORE_FLAGS))
def test_core_flag_default_and_set(name):
    default = jp.get_flags(name)[name]
    assert tp.get_flags(name) == {name: default}
    assert type(tp.get_flags(name)[name]) is type(default)
    try:
        tp.set_flags({name: CORE_FLAGS[name]})
        assert tp.get_flags([name]) == {name: CORE_FLAGS[name]}
        tp.set_flags({name: str(CORE_FLAGS[name])})  # string values parse by the default's type
        assert tp.get_flags(name) == {name: CORE_FLAGS[name]}
    finally:
        tp.set_flags({name: default})
    assert tp.get_flags(name) == {name: default}
    (doc,) = [d for d in tp.core.flags.describe_flags(name[len("FLAGS_"):]) if d["name"] == name]
    assert doc["default"] == default and "read nowhere" in doc["doc"]


def test_flags_of_later_items_still_raise():
    """FLAGS_check_programs is ported (item 12b): its levels are accepted;
    item 13's flag still raises."""
    try:
        for level in (1, 2, 0):
            tp.set_flags({"FLAGS_check_programs": level})
            assert tp.get_flags("FLAGS_check_programs") == {"FLAGS_check_programs": level}
    finally:
        tp.set_flags({"FLAGS_check_programs": 0})
    with pytest.raises(NotImplementedError, match="item 13"):
        tp.set_flags({"FLAGS_eager_capture_sharded": False})
