"""Stand-ins for the cluster schedulers the port drives (pyspark, ray)
where they are not installed: process-backed fakes of the slice of their
API that :mod:`horovod_tpu_torch.spark` and :mod:`horovod_tpu_torch.ray`
use. The port's code never imports them; tests and ``chip_smoke.py``
hand them in (``spark_context=``, ``sys.modules["ray"]``)."""
