"""The worker of :meth:`ElasticRayExecutor.run` — the port's copy of
``horovod_tpu/ray/elastic_worker.py``: load the pickled user function,
call it (it keeps its own elastic state through ``hvd.elastic.run``),
and leave this rank's return value where the driver collects it.

Run as ``python -m horovod_tpu_torch.ray.elastic_worker FN_PATH
RESULTS_DIR``.
"""

import os
import pickle
import sys

from ..common.config import runtime_env
from ..runner.task_fn import _pickler


def main(fn_path: str, results_dir: str) -> int:
    with open(fn_path, "rb") as f:
        worker_fn = _pickler().load(f)
    value = worker_fn()
    rank = runtime_env("PROC_ID", "0")
    world = runtime_env("NUM_PROC", "1")
    os.makedirs(results_dir, exist_ok=True)
    # The world size in the name lets the driver keep only the final
    # world's values when an earlier epoch was cut short.
    name = f"rank_{rank}_of_{world}.pkl"
    tmp = os.path.join(results_dir, f".{name}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(value, f)
    os.replace(tmp, os.path.join(results_dir, name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
