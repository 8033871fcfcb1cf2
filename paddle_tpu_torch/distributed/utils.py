"""``paddle.distributed.utils``: the launch-era cluster helpers and the MoE
collectives of ``paddle_tpu/distributed/utils.py`` wait for ROADMAP queue 1
items 13b (MoE) and 13c (the cluster model); ``find_free_ports`` is here."""
from __future__ import annotations

import socket

__all__ = ["find_free_ports"]


def find_free_ports(num):
    """``num`` free TCP ports of the loopback, or None."""
    socks, ports = [], set()
    try:
        for _ in range(int(num)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.add(s.getsockname()[1])
    except OSError:
        return None
    finally:
        for s in socks:
            s.close()
    return ports
