"""Launches beyond this machine (``horovod_tpu_torch/runner/``) and the
port's ``store.py``, against the JAX package's, after the reference tests
of ``tests/test_runner.py`` and ``tests/test_parquet_store.py``.

Hosts that resolve to this machine stand for other machines: an ``ssh``
on ``PATH`` (the JAX tests' ``fake_ssh``, plus a log of each call's
argv) runs the remote command here, and the hosts are ``127.0.0.2`` and
``127.0.0.3`` (Linux routes all of 127/8 to loopback; neither is a name
the launcher takes for this machine).

* ``--autotune`` and ``--autotune-log-file`` export the JAX launcher's
  variables.
* ``run_ssh`` starts one process a slot in host order (PROC_IDs 0-3,
  local ranks 0 and 1 on each host, ``HVD_TPU_HOSTNAME`` set); a
  ``*_SECRET`` variable reaches the worker and is absent from every
  argv the ``ssh`` saw; a real gloo world of 2 over it runs a port
  ``allreduce``; ``run(use_ssh=True)`` returns both results in rank
  order.
* NIC discovery: the ``driver_service --serve`` banner and its two
  queries; ``common_interfaces`` equals JAX's; discovery over the fake
  ``ssh`` returns an address of this machine or None and never raises.
* LSF: ``lsf_hosts`` equals JAX's for each of the three environment
  forms; a launch inside an allocation fans out to its hosts; a stale
  ``LSB_JOBID`` launches locally.
* GPU host discovery: ``CUDA_VISIBLE_DEVICES`` and ``nvidia-smi -L``
  counts; with ``-np`` unset the launcher runs one worker a GPU, with
  none found one.
* An elastic launch over ssh (``--elastic -np 2 --min-np 1 --max-np 2 -H
  127.0.0.2:1,127.0.0.3:1``) of ``chip_smoke.py``'s elastic worker on
  ``gpt_tiny``: the second host's worker crashes, the world goes on on
  the first host, a preemption there restarts it from its persisted
  step, and the final step is reached with every restore's digest its
  commit's.
* ``store.py``: ``LocalStore`` and ``FsspecStore`` (``memory://``) round
  trips, the run layout's paths equal the JAX store's, and ``gs://``
  without gcsfs raises the JAX message.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

from horovod_tpu_torch.runner import driver_service as ds
from horovod_tpu_torch.runner import gpu_hosts
from horovod_tpu_torch.runner import hosts as hosts_lib
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner import lsf
from horovod_tpu_torch import store as P_store
from test_torch_port_worlds import REPO, world_slot

HOSTS2 = "127.0.0.2:1,127.0.0.3:1"
ELASTIC_STEPS = 8


@pytest.fixture(scope="module")
def J():
    from horovod_tpu import store as jstore
    from horovod_tpu.runner import driver_service as jds
    from horovod_tpu.runner import launch as jlaunch
    from horovod_tpu.runner import lsf as jlsf

    return types.SimpleNamespace(ds=jds, launch=jlaunch, lsf=jlsf,
                                 store=jstore)


@pytest.fixture()
def fake_ssh(tmp_path, monkeypatch):
    """A PATH-shadowing ``ssh`` that runs the remote command locally (the
    JAX tests' fixture) and appends each call's argv to ``ssh.log``."""
    fake = tmp_path / "ssh"
    log = tmp_path / "ssh.log"
    fake.write_text(
        "#!/bin/bash\n"
        f"printf '%s\\n' \"$*\" >> {log}\n"
        "# drop ssh options (-o v / -p v), take <host> <command...>\n"
        "args=()\n"
        "while [[ $# -gt 0 ]]; do\n"
        "  case $1 in\n"
        "    -o|-p) shift 2;;\n"
        "    *) args+=(\"$1\"); shift;;\n"
        "  esac\n"
        "done\n"
        "host=${args[0]}\n"
        "exec bash -c \"${args[*]:1}\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    return types.SimpleNamespace(path=fake, log=log)


def _env_worker(tmp_path, out_dir):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import json, os
        keys = ("HVD_TPU_PROC_ID", "HVD_TPU_NUM_PROC", "HVD_TPU_LOCAL_RANK",
                "HVD_TPU_LOCAL_SIZE", "HVD_TPU_HOSTNAME",
                "HVD_TPU_COORDINATOR", "HVD_TPU_TEST_SECRET")
        env = {{k: os.environ.get(k) for k in keys}}
        with open(os.path.join(r"{out_dir}", env["HVD_TPU_PROC_ID"]),
                  "w") as f:
            json.dump(env, f)
    """))
    return script


# -- the knobs ------------------------------------------------------------------

def test_autotune_flags_export_their_variables(J, tmp_path):
    argv = ["--autotune", "--autotune-log-file", str(tmp_path / "a.csv"),
            "python", "x.py"]
    env = launch.knob_env(launch.parse_args(argv))
    assert env["HVD_TPU_AUTOTUNE"] == "1"
    assert env["HVD_TPU_AUTOTUNE_LOG"] == str(tmp_path / "a.csv")
    assert env == J.launch.knob_env(J.launch.parse_args(argv))


# -- the ssh fan-out --------------------------------------------------------------

def test_run_ssh_one_process_a_slot(tmp_path, fake_ssh):
    out = tmp_path / "out"
    out.mkdir()
    script = _env_worker(tmp_path, out)
    rc = launch.run_ssh(hosts_lib.parse_hosts("127.0.0.2:2,127.0.0.3:2"),
                        [sys.executable, str(script)],
                        {"HVD_TPU_TEST_SECRET": "s3cr3t value"}, np=4)
    assert rc == 0
    assert sorted(os.listdir(out)) == ["0", "1", "2", "3"]
    envs = [json.loads((out / str(i)).read_text()) for i in range(4)]
    assert [e["HVD_TPU_HOSTNAME"] for e in envs] == \
        ["127.0.0.2", "127.0.0.2", "127.0.0.3", "127.0.0.3"]
    assert [e["HVD_TPU_LOCAL_RANK"] for e in envs] == ["0", "1", "0", "1"]
    assert {e["HVD_TPU_LOCAL_SIZE"] for e in envs} == {"2"}
    assert {e["HVD_TPU_NUM_PROC"] for e in envs} == {"4"}
    assert len({e["HVD_TPU_COORDINATOR"] for e in envs}) == 1
    assert envs[0]["HVD_TPU_COORDINATOR"].startswith("127.0.0.2:")
    assert {e["HVD_TPU_TEST_SECRET"] for e in envs} == {"s3cr3t value"}
    argvs = fake_ssh.log.read_text()
    assert argvs.count("HVD_TPU_PROC_ID=") == 4
    assert "s3cr3t" not in argvs


def test_run_ssh_fails_fast(tmp_path, fake_ssh):
    script = tmp_path / "w.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['HVD_TPU_PROC_ID'] == '1':\n"
                      "    sys.exit(5)\n"
                      "time.sleep(120)\n")
    rc = launch.run_ssh(hosts_lib.parse_hosts(HOSTS2),
                        [sys.executable, str(script)], {}, np=2)
    assert rc == 5


def test_gloo_world_over_ssh(tmp_path, fake_ssh):
    out = tmp_path / "out"
    script = tmp_path / "w.py"
    script.write_text(
        "import torch, horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "s = hvd.allreduce(torch.tensor([hvd.rank() + 1.0]), op=hvd.Sum)\n"
        f"open(r'{out}' + str(hvd.rank()), 'w').write(\n"
        "    f'{hvd.size()} {float(s[0])}')\n"
        "hvd.shutdown()\n")
    with world_slot():
        assert launch.run_commandline(
            ["-np", "2", "-H", HOSTS2, sys.executable, str(script)]) == 0
    assert [(tmp_path / f"out{r}").read_text() for r in (0, 1)] == \
        ["2 3.0", "2 3.0"]


def _rank_result(tag):
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        out = hvd.allreduce(torch.tensor([hvd.rank() + 1.0]), op=hvd.Sum)
        return tag, hvd.rank(), float(out[0])
    finally:
        hvd.shutdown()


def test_run_use_ssh_returns_results_in_rank_order(fake_ssh):
    from horovod_tpu_torch.runner import run

    with world_slot():
        got = run(_rank_result, args=("t",), np=2, use_ssh=True,
                  hosts=HOSTS2)
    assert got == [("t", 0, 3.0), ("t", 1, 3.0)]
    assert fake_ssh.log.read_text().count("task_fn") == 2


# -- NIC discovery ---------------------------------------------------------------

def test_driver_service_serve_banner_and_queries():
    p = subprocess.Popen([sys.executable, "-m",
                          "horovod_tpu_torch.runner.driver_service",
                          "--serve", "--ttl", "30"], stdout=subprocess.PIPE,
                         text=True, cwd=str(REPO))
    try:
        line = p.stdout.readline().strip()
        assert line.startswith("TASKSERVER ")
        port = int(line.split()[1])
        assert ds.probe_reachable(("127.0.0.1", port))
        assert ds.query_interfaces(("127.0.0.1", port)) == \
            ds.local_addresses()
    finally:
        p.terminate()
        p.wait(timeout=10)


@pytest.mark.parametrize("host_ifaces", [
    {"a": {"lo": "127.0.0.1", "eth0": "10.0.0.1", "ib0": "10.1.0.1"},
     "b": {"lo": "127.0.0.1", "eth0": "10.0.0.2"}},
    {"a": {"lo": "127.0.0.1", "eth0": "10.0.0.1"}},
    {"a": {"lo0": "127.0.0.1", "docker0": "172.17.0.1"},
     "b": {"lo0": "127.0.0.1", "docker0": "172.17.0.1", "eth1": "x"}},
    {}])
def test_common_interfaces_match_jax(J, host_ifaces):
    assert ds.common_interfaces(host_ifaces) == \
        J.ds.common_interfaces(host_ifaces)


def test_nic_discovery_over_ssh_never_raises(fake_ssh, monkeypatch):
    monkeypatch.chdir(REPO)
    ip = launch._nic_discovery_coordinator(["127.0.0.2", "127.0.0.3"], None)
    assert ip is None or ip in ds.local_addresses().values()
    assert fake_ssh.log.read_text().count("driver_service --serve") == 2
    monkeypatch.setenv("HVD_TPU_NIC_DISCOVERY", "1")
    host, discovered = launch.coordinator_host(["127.0.0.2", "127.0.0.3"])
    assert (host == ip) if discovered else (host == "127.0.0.2")


# -- LSF -------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["hostfile", "mcpu", "hosts"])
def test_lsf_hosts_match_jax(J, form, tmp_path, monkeypatch):
    for var in ("LSB_DJOB_HOSTFILE", "LSB_MCPU_HOSTS", "LSB_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("LSB_JOBID", raising=False)
    assert not lsf.in_lsf() and not J.lsf.in_lsf()
    monkeypatch.setenv("LSB_JOBID", "123")
    if form == "hostfile":
        hf = tmp_path / "djob"
        hf.write_text("nodeA\nnodeA\nnodeB\n")
        monkeypatch.setenv("LSB_DJOB_HOSTFILE", str(hf))
        monkeypatch.setenv("LSB_MCPU_HOSTS", "other 9")
    elif form == "mcpu":
        monkeypatch.setenv("LSB_MCPU_HOSTS", "nodeA 4 nodeB 4")
        monkeypatch.setenv("LSB_HOSTS", "other")
    else:
        monkeypatch.setenv("LSB_HOSTS", "nodeA nodeA nodeB nodeC nodeC")
    got = [(h.hostname, h.slots) for h in lsf.lsf_hosts()]
    assert got == [(h.hostname, h.slots) for h in J.lsf.lsf_hosts()]
    assert got[0][0] == "nodeA"


def test_launch_inside_lsf_takes_its_hosts(tmp_path, fake_ssh, monkeypatch):
    out = tmp_path / "out"
    out.mkdir()
    script = _env_worker(tmp_path, out)
    monkeypatch.setenv("LSB_JOBID", "7")
    monkeypatch.delenv("LSB_DJOB_HOSTFILE", raising=False)
    monkeypatch.setenv("LSB_MCPU_HOSTS", "127.0.0.2 1 127.0.0.3 1")
    assert launch.run_commandline(["-np", "2", sys.executable,
                                   str(script)]) == 0
    hosts = [json.loads((out / str(i)).read_text())["HVD_TPU_HOSTNAME"]
             for i in range(2)]
    assert hosts == ["127.0.0.2", "127.0.0.3"]


def test_stale_lsb_jobid_launches_locally(tmp_path, monkeypatch, capsys):
    for var in ("LSB_DJOB_HOSTFILE", "LSB_MCPU_HOSTS", "LSB_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LSB_JOBID", "stale")
    out = tmp_path / "out"
    out.mkdir()
    script = _env_worker(tmp_path, out)
    assert launch.run_commandline(["-np", "1", sys.executable,
                                   str(script)]) == 0
    assert "ignoring LSF environment" in capsys.readouterr().err
    env = json.loads((out / "0").read_text())
    assert env["HVD_TPU_COORDINATOR"].startswith("127.0.0.1:")


# -- GPU host discovery ------------------------------------------------------------

SMI = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-1a2b)\n"
       "GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-3c4d)\n"
       "  MIG 1g.10gb Device 0: (UUID: MIG-5e6f)\n"
       "GPU 2: NVIDIA H100 80GB HBM3 (UUID: GPU-7a8b)\n")


@pytest.mark.parametrize("value,count", [
    ("0,1", 2), ("", None), ("-1", None), ("0,-1,1", 1),
    ("GPU-8f1c2d3e-aaaa-bbbb-cccc-000000000001,"
     "GPU-8f1c2d3e-aaaa-bbbb-cccc-000000000002", 2),
    ("zero", None), ("0,,1", None)])
def test_cuda_visible_devices_counts(value, count):
    assert gpu_hosts.local_gpu_count({"CUDA_VISIBLE_DEVICES": value},
                                      smi_output=SMI) == count


def test_nvidia_smi_listing_counts():
    assert gpu_hosts.local_gpu_count({}, smi_output=SMI) == 3
    assert gpu_hosts.local_gpu_count({}, smi_output="") is None
    assert gpu_hosts.count_smi_lines("No devices were found\n") == 0


@pytest.mark.parametrize("gpus,workers", [(3, 3), (0, 1), (None, 1)])
def test_unset_np_runs_one_worker_a_gpu(tmp_path, monkeypatch, gpus,
                                        workers):
    for var in ("LSB_JOBID", "HVD_TPU_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(gpu_hosts, "local_gpu_count", lambda: gpus)
    out = tmp_path / "out"
    out.mkdir()
    script = _env_worker(tmp_path, out)
    assert launch.run_commandline([sys.executable, str(script)]) == 0
    assert sorted(os.listdir(out)) == [str(i) for i in range(workers)]
    # An explicit -np is kept.
    for f in os.listdir(out):
        os.remove(out / f)
    assert launch.run_commandline(["-np", "1", sys.executable,
                                   str(script)]) == 0
    assert os.listdir(out) == ["0"]


# -- elastic over ssh ------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elastic_epochs_over_ssh(tmp_path, fake_ssh):
    cs = _chip_smoke()
    cfg = {"model": "gpt_tiny", "device": "cpu", "batch": 2, "seq": 32,
           "steps": ELASTIC_STEPS, "persist_every": 2, "qmin": 0,
           "final_check": True}
    plan = {"seed": 5, "faults": [
        {"site": "crash", "step": 3, "host": "127.0.0.3"},
        {"site": "preempt", "step": 5, "host": "127.0.0.2"}]}
    env = {"HVD_TPU_ELASTIC_FORCE_LOCAL": "", "HVD_TPU_BLACKLIST_TTL_S": "600",
           "HVD_TPU_ELASTIC_GRACE_SECS": "10",
           "PATH": os.environ["PATH"], "PYTHONPATH": str(REPO)}
    with world_slot():
        rc, _, events, inj, log = cs.run_elastic_job(
            str(tmp_path / "job"), cfg, plan, env_extra=env, timeout=240,
            hosts=HOSTS2, nps=(2, 1, 2))
    assert rc == 0, log[-4000:]
    assert sorted(i["site"] for i in inj) == ["crash", "preempt"]
    argvs = fake_ssh.log.read_text()
    assert "127.0.0.3" in argvs and "127.0.0.2" in argvs
    assert "RENDEZVOUS_SECRET" not in argvs
    rep = cs.elastic_report(events, inj)
    assert rep["restores"] and all(ok for _, ok in rep["restores"]), rep
    final = rep["finals"][0]
    assert final["step"] == ELASTIC_STEPS and final["committed_equal"]
    assert final["persisted_equal"]


# -- store.py --------------------------------------------------------------------

@pytest.fixture()
def memstores(J):
    import fsspec

    stores = (P_store.Store.create("memory://hvd-port-store"),
              J.store.Store.create("memory://hvd-port-store-jax"))
    yield stores
    fs = fsspec.filesystem("memory")
    for path in ("/hvd-port-store", "/hvd-port-store-jax"):
        try:
            fs.rm(path, recursive=True)
        except FileNotFoundError:
            pass


def test_local_store_round_trip_and_layout_match_jax(J, tmp_path):
    s = P_store.Store.create(str(tmp_path / "p"))
    j = J.store.Store.create(str(tmp_path / "p"))
    assert isinstance(s, P_store.LocalStore)
    p = s.path_join(s.prefix(), "a", "b.pkl")
    assert not s.exists(p)
    s.write_obj(p, {"x": 1})
    assert s.exists(p) and s.read_obj(p) == {"x": 1}
    assert j.read_obj(p) == {"x": 1}
    assert list(s.listdir(s.path_join(s.prefix(), "a"))) == ["b.pkl"]
    with s.open(s.path_join(s.prefix(), "c", "d.bin"), "wb") as f:
        f.write(b"xy")
    assert s.read(s.path_join(s.prefix(), "c", "d.bin")) == b"xy"
    for fn in ("get_run_path", "get_checkpoint_path", "get_logs_path",
               "get_data_path"):
        assert getattr(s, fn)("r1") == getattr(j, fn)("r1")


def test_fsspec_store_round_trip_and_layout_match_jax(memstores):
    s, j = memstores
    assert isinstance(s, P_store.FsspecStore)
    p = s.path_join(s.prefix(), "a", "b.pkl")
    assert not s.exists(p)
    s.write_obj(p, {"x": 1})
    assert s.exists(p) and s.read_obj(p) == {"x": 1}
    assert list(s.listdir(s.path_join(s.prefix(), "a"))) == ["b.pkl"]
    with s.open(p, "rb") as f:
        assert f.read(1)
    ckpt = s.get_checkpoint_path("r1")
    assert "runs" in ckpt and ckpt.startswith(s.prefix())
    for fn in ("get_run_path", "get_checkpoint_path", "get_logs_path",
               "get_data_path"):
        assert getattr(s, fn)("r1").replace("hvd-port-store",
                                            "hvd-port-store-jax") == \
            getattr(j, fn)("r1")


def test_gcs_without_gcsfs_raises_the_jax_message(J, monkeypatch):
    monkeypatch.setitem(sys.modules, "gcsfs", None)
    msgs = []
    for mod in (P_store, J.store):
        with pytest.raises(ImportError) as e:
            mod.Store.create("gs://bucket/prefix")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "GCSStore requires gcsfs" in msgs[0]
