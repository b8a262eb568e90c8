"""The worker of :func:`horovod_tpu_torch.spark.run_elastic`, run in a
pool task's subprocess (Horovod's command that ``gloo_run_elastic``
starts inside a SparkTaskService) — the port's copy of
``horovod_tpu/spark/elastic_worker.py``.

Everything travels over the driver's rendezvous KV (executors share no
filesystem with the driver): the pickled function comes from
``sparkpool/fn``, the epoch's coordinator is negotiated under
``sparkep/<epoch>``, and this rank's return value goes to
``sparkres/<epoch>/<rank>``. The function keeps its own elastic state
(``hvd.elastic.run``).

Run as ``python -m horovod_tpu_torch.spark.elastic_worker``.
"""

from __future__ import annotations

import os
import pickle
import sys

from ..common.config import runtime_env
from ..runner.rendezvous import RendezvousClient
from ..runner.task_fn import _pickler
from . import negotiate_coordinator
from .task_pool import SCOPE as POOL_SCOPE

RESULT_SCOPE = "sparkres"


def main() -> int:
    addr = runtime_env("RENDEZVOUS", required=True)
    host, port = addr.rsplit(":", 1)
    secret = runtime_env("RENDEZVOUS_SECRET", "")
    client = RendezvousClient(host, int(port), timeout_s=30.0,
                              secret=secret.encode() if secret else None)
    epoch = int(runtime_env("SPARK_EPOCH", required=True))
    rank = int(runtime_env("PROC_ID", required=True))
    world = int(runtime_env("NUM_PROC", required=True))

    env = negotiate_coordinator(client, rank, world,
                                scope=f"sparkep/{epoch}")
    os.environ.update(env)

    blob = client.wait(POOL_SCOPE, "fn", timeout_s=60.0)
    fn, args, kwargs = _pickler().loads(blob)
    value = fn(*args, **kwargs)
    client.put(RESULT_SCOPE, f"{epoch}/{rank}", pickle.dumps(value))
    return 0


if __name__ == "__main__":
    sys.exit(main())
