"""One rank of ``tests/torch_dist_pool.RankPool``: joins the others over
gloo on the CPU, then runs the cases of ``tests/torch_dist_cases.py`` read
from stdin, one pickled ``(case, kwargs)`` line each, answering one pickled
``(ok, result or traceback)`` line each, until stdin closes."""
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import torch_dist_cases as cases  # noqa: E402
from torch_dist_pool import decode, encode  # noqa: E402


def main():
    torch.set_num_threads(1)
    pt.set_device("cpu")
    pt.distributed.init_parallel_env()
    out = sys.stdout.buffer
    sys.stdout = sys.stderr  # prints of the cases stay off the answer stream
    for line in sys.stdin.buffer:
        case, kwargs = decode(line)
        try:
            result = (True, getattr(cases, case)(**kwargs))
        except Exception:
            result = (False, traceback.format_exc())
        out.write(encode(result))
        out.flush()


if __name__ == "__main__":
    main()
