"""Start N processes of one command with the MXTPU_* contract (the port's
twin of tools/launch.py, its ``local`` launcher):

    python -m mxnet_tpu_torch.launch -n 2 python train.py ...

Each process gets ``MXTPU_COORDINATOR`` (localhost and a free port),
``MXTPU_NUM_PROCESSES``, ``MXTPU_PROCESS_ID`` and ``MXTPU_RESTART_COUNT``;
``mxnet_tpu_torch.parallel.dist`` brings the world up from them.  Each
process starts a session of its own, and when any of them fails the
launcher kills every process group of the world, so no survivor waits in
a collective for a dead peer.  ``--max-restarts K`` respawns the whole
world up to K times after a failure, ``--respawn-delay`` seconds later,
with ``MXTPU_RESTART_COUNT`` incremented (``parallel.elastic.is_recovery``
reads it; ``fit_elastic`` resumes from the newest checkpoint).  The exit
code is the first failing rank's, 0 when all succeed.

``--launcher ssh`` (one process a host) and ``--elastic`` (live resize)
arrive with the multi-host and live-resize parts of the distributed slice
and raise.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from .base import MXNetError

__all__ = ["launch_local", "kill_world", "main"]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def kill_world(procs):
    """SIGKILL the process group of every process still running, and reap
    them."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def launch_local(n, command, max_restarts=0, respawn_delay=3.0):
    """Run ``n`` copies of ``command`` on this host with the contract;
    respawn the world up to ``max_restarts`` times after a failure.
    Returns the first non-zero exit code, 0 if all succeed."""
    attempt = 0
    while True:
        port = _free_port()
        procs = []
        for r in range(n):
            env = dict(os.environ)
            env["MXTPU_COORDINATOR"] = "localhost:%d" % port
            env["MXTPU_NUM_PROCESSES"] = str(n)
            env["MXTPU_PROCESS_ID"] = str(r)
            env["MXTPU_RESTART_COUNT"] = str(attempt)
            procs.append(subprocess.Popen(command, env=env,
                                          start_new_session=True))
        rc = 0
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [c for c in codes if c not in (None, 0)]
                if failed:
                    rc = failed[0]
                    break
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.1)
        except KeyboardInterrupt:
            kill_world(procs)
            return 1
        finally:
            kill_world(procs)
        if rc == 0 or attempt >= max_restarts:
            return rc
        attempt += 1
        print("launch: a rank failed (rc=%d), restart %d/%d in %r s"
              % (rc, attempt, max_restarts, respawn_delay), file=sys.stderr)
        time.sleep(respawn_delay)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", choices=("local", "ssh"), default="local")
    ap.add_argument("--hostfile", default=None,
                    help="the ssh launcher's hosts (refused with it)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="respawn the world up to this many times after a "
                         "rank fails")
    ap.add_argument("--respawn-delay", type=float, default=3.0,
                    help="seconds between a failure and the respawn")
    ap.add_argument("--elastic", default=None, metavar="MIN:MAX")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    if args.launcher == "ssh":
        raise MXNetError("--launcher ssh is not ported yet: it arrives with "
                         "the multi-host part of the distributed slice")
    if args.elastic is not None:
        raise MXNetError("--elastic is not ported yet: it arrives with the "
                         "live-resize part of the distributed slice")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    return launch_local(args.num_workers, args.command,
                        max_restarts=args.max_restarts,
                        respawn_delay=args.respawn_delay)


if __name__ == "__main__":
    sys.exit(main())
