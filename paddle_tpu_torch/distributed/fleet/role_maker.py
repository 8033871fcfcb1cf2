"""RoleMaker — parses the launch environment contract
(``paddle_tpu/distributed/fleet/role_maker.py``).

Reference analogue: fleet/base/role_maker.py (PaddleCloudRoleMaker parsing
PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS /
TRAINING_ROLE ...).
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False

    def worker_index(self):
        raise NotImplementedError

    def worker_num(self):
        raise NotImplementedError

    def is_worker(self):
        raise NotImplementedError

    def is_first_worker(self):
        return self.is_worker() and self.worker_index() == 0


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._generate_role()

    def _generate_role(self):
        self._trainer_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._trainers_num = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else []
        seps = os.getenv("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = seps.split(",") if seps else []
        self._role = (
            Role.SERVER
            if os.getenv("TRAINING_ROLE", "TRAINER") == "PSERVER"
            else Role.WORKER
        )
        self._role_is_generated = True

    def worker_index(self):
        return self._trainer_id

    def worker_num(self):
        return self._trainers_num

    def server_num(self):
        return len(self._server_endpoints)

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        self._kwargs = kwargs
        super().__init__(is_collective)

    def _generate_role(self):
        self._trainer_id = self._kwargs.get("current_id", 0)
        self._trainers_num = self._kwargs.get("worker_num", 1)
        self._worker_endpoints = self._kwargs.get("worker_endpoints", [])
        self._server_endpoints = self._kwargs.get("server_endpoints", [])
        role = self._kwargs.get("role", Role.WORKER)
        self._role = role
        self._role_is_generated = True
