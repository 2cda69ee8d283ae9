#!/usr/bin/env python
"""Multi-process launcher for the PyTorch port (the twin of
``tools/launch.py``; ref: tools/launch.py — upstream spawns ps-lite
servers/workers over ssh; here each process is a rank of one
``torch.distributed`` group).

Local mode (-n workers on this host: gloo ranks on the CPU, or one rank a
card with NCCL):

    python tools/torch_launch.py -n 2 python examples/torch_train_long_context.py --device cpu

Each worker gets the ps-lite contract upstream's launcher uses
(DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT / DMLC_NUM_WORKER / DMLC_WORKER_ID)
and torch's own (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
LOCAL_RANK / LOCAL_WORLD_SIZE), so a script joins with
``mxnet_tpu_torch.parallel.distributed.init_process_group()`` (which reads
either set) or with ``torch.distributed.init_process_group("gloo")`` alone.
``--timeout`` bounds the whole job: a worker still running then is killed
and the launcher exits 124.
"""
import argparse
import os
import socket
import subprocess
import sys
import time


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(base, rank, n, coord, extra=()):
    """The environment of worker ``rank`` of ``n``, the coordinator at
    ``coord`` (host:port)."""
    env = dict(base)
    host, _, port = coord.rpartition(":")
    env["DMLC_PS_ROOT_URI"] = host
    env["DMLC_PS_ROOT_PORT"] = port
    env["DMLC_NUM_WORKER"] = str(n)
    env["DMLC_WORKER_ID"] = str(rank)
    env["DMLC_ROLE"] = "worker"
    env["MASTER_ADDR"] = host
    env["MASTER_PORT"] = port
    env["WORLD_SIZE"] = str(n)
    env["RANK"] = str(rank)
    env["LOCAL_RANK"] = str(rank)
    env["LOCAL_WORLD_SIZE"] = str(n)
    for kv in extra:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default: 127.0.0.1:<free port>)")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VALUE for every worker")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds for the whole job (default: none)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")

    coord = args.coordinator or ("127.0.0.1:%d" % _free_port())
    procs = [subprocess.Popen(args.command, env=worker_env(
        os.environ, rank, args.num_workers, coord, args.env))
        for rank in range(args.num_workers)]
    deadline = None if args.timeout is None else \
        time.monotonic() + args.timeout
    rc = 0
    try:
        for p in procs:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                rc = p.wait(timeout=left) or rc
            except subprocess.TimeoutExpired:
                rc = 124
                break
    except KeyboardInterrupt:
        rc = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
