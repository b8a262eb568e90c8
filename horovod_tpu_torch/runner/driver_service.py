"""Driver/task network services: routable-interface discovery, the
port's copy of ``horovod_tpu/runner/driver_service.py``.

Horovod's launcher starts a task server on every host (over ssh); each
registers its network interfaces with the driver, and the intersection
of the interface sets, verified by connectivity probes, selects the NICs
the rendezvous address uses. The same protocol over a minimal TCP/JSON
service: ``python -m horovod_tpu_torch.runner.driver_service --serve
[--ttl S]`` prints ``TASKSERVER <port>`` once it listens and answers
``ifaces`` (this host's interface -> IPv4 map) and ``ping``. The
launcher runs it when ``HVD_TPU_NIC_DISCOVERY=1``
(``launch._nic_discovery_coordinator``); loopback is dropped between
hosts, and a discovery that finds nothing leaves the first host's name.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple


def local_addresses() -> Dict[str, str]:
    """interface name -> IPv4 address for this host (reference
    network.py get_local_host_addresses)."""
    addrs: Dict[str, str] = {}
    try:
        import array
        import fcntl

        SIOCGIFCONF = 0x8912
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        max_ifaces = 64
        bufsize = max_ifaces * 40
        buf = array.array("B", b"\0" * bufsize)
        ifconf = struct.pack("iL", bufsize,
                             buf.buffer_info()[0])
        outbytes = struct.unpack("iL", fcntl.ioctl(
            s.fileno(), SIOCGIFCONF, ifconf))[0]
        data = buf.tobytes()[:outbytes]
        # Each record: 16-byte name + sockaddr (40-byte stride on 64-bit).
        for i in range(0, outbytes, 40):
            name = data[i:i + 16].split(b"\0", 1)[0].decode()
            ip = socket.inet_ntoa(data[i + 20:i + 24])
            addrs[name] = ip
        s.close()
    except (OSError, ImportError, struct.error):
        # Portable fallback: hostname resolution + loopback.
        addrs["lo"] = "127.0.0.1"
        try:
            addrs["default"] = socket.gethostbyname(socket.gethostname())
        except OSError:
            pass
    return addrs


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline().strip()
        if line == b"ifaces":
            self.wfile.write(
                json.dumps(local_addresses()).encode() + b"\n")
        elif line == b"ping":
            self.wfile.write(b"pong\n")


class TaskServer:
    """Per-host service answering interface queries and connectivity
    probes (reference task_service.py BasicTaskService)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._srv.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "TaskServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def _query(addr: Tuple[str, int], command: str,
           timeout_s: float = 5.0) -> Optional[str]:
    try:
        with socket.create_connection(addr, timeout=timeout_s) as s:
            s.sendall(command.encode() + b"\n")
            f = s.makefile("rb")
            return f.readline().decode().strip()
    except OSError:
        return None


def query_interfaces(addr: Tuple[str, int],
                     timeout_s: float = 5.0) -> Dict[str, str]:
    raw = _query(addr, "ifaces", timeout_s)
    return json.loads(raw) if raw else {}


def probe_reachable(addr: Tuple[str, int],
                    timeout_s: float = 2.0) -> bool:
    return _query(addr, "ping", timeout_s) == "pong"


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m horovod_tpu_torch.runner.driver_service --serve`` — the
    per-host task server the launcher starts over ssh. Prints
    ``TASKSERVER <port>`` once ready, then serves until killed."""
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ttl", type=float, default=0.0,
                    help="self-terminate after this many seconds "
                         "(0 = serve forever); launcher-started servers "
                         "use a TTL so a dropped ssh channel cannot "
                         "strand listeners")
    a = ap.parse_args(argv)
    if not a.serve:
        ap.error("--serve required")
    srv = TaskServer(port=a.port).start()
    print(f"TASKSERVER {srv.port}", flush=True)
    deadline = time.monotonic() + a.ttl if a.ttl > 0 else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(min(3600.0, a.ttl or 3600.0))
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def common_interfaces(
        host_ifaces: Dict[str, Dict[str, str]]) -> List[str]:
    """Interface names present on EVERY host (reference
    driver_service.py:201-221 _get_common_interfaces: the driver
    intersects the registered sets)."""
    sets = [set(ifaces) for ifaces in host_ifaces.values()]
    if not sets:
        return []
    common = set.intersection(*sets)
    # Loopback can't route between hosts — exclude it when more than one
    # host is involved (reference filters lo the same way).
    if len(host_ifaces) > 1:
        common = {i for i in common if not i.startswith("lo")}
    return sorted(common)


def discover_routable_interfaces(
        task_addrs: Dict[str, Tuple[str, int]],
        wait_timeout_s: float = 30.0) -> List[str]:
    """Query every host's task server and intersect (the driver side of
    the protocol). ``task_addrs``: hostname -> (ip, port) of its
    TaskServer.

    EVERY host must answer: an interface set intersected over a subset
    of hosts is not 'routable' — the missing host might lack the chosen
    NIC (the reference driver likewise waits for all task services to
    register, driver_service.py:49-120). Slow-starting servers are
    retried until ``wait_timeout_s``, then a RuntimeError names the
    unreachable hosts."""
    import time

    host_ifaces: Dict[str, Dict[str, str]] = {}
    pending = dict(task_addrs)
    deadline = time.monotonic() + wait_timeout_s
    while pending:
        for host, addr in list(pending.items()):
            if probe_reachable(addr):
                host_ifaces[host] = query_interfaces(addr)
                del pending[host]
        if not pending:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"task servers unreachable on hosts "
                f"{sorted(pending)} after {wait_timeout_s}s — cannot "
                "determine routable interfaces for the full host set")
        time.sleep(0.2)
    return common_interfaces(host_ifaces)


if __name__ == "__main__":
    import sys

    sys.exit(main())
