"""The worker entry point of :func:`horovod_tpu_torch.runner.run`: load
the pickled ``(func, args, kwargs)``, call it, and write ``("ok",
result)`` or ``("error", traceback)`` to ``<out_dir>/result_<rank>.pkl``
(a temporary file and ``os.replace``); the launcher set the world's
environment, so ``func`` may call ``hvd.init()``.

Run as ``python -m horovod_tpu_torch.runner.task_fn PAYLOAD OUT_DIR``.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

from ..common.config import runtime_env


def _pickler():
    """cloudpickle where it is installed (closures and lambdas travel),
    else pickle (module-level functions only)."""
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:
        return pickle


def main(payload_path: str, out_dir: str) -> int:
    pid = int(runtime_env("PROC_ID", "0"))
    try:
        with open(payload_path, "rb") as f:
            func, args, kwargs = _pickler().load(f)
        result = func(*args, **kwargs)
        status = "ok"
    except BaseException as e:      # reported, then the exit code says so
        result = "".join(traceback.format_exception(
            type(e), e, e.__traceback__))
        status = "error"
    tmp = os.path.join(out_dir, f".result_{pid}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump((status, result), f)
    os.replace(tmp, os.path.join(out_dir, f"result_{pid}.pkl"))
    if status == "error":
        sys.stderr.write(result)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
