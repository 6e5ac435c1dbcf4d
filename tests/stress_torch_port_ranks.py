"""Run the rank pair of ``test_column_parallel_modules_match_unsharded`` many
times, several pairs at once, and count how the ranks ended.

    python tests/stress_torch_port_ranks.py [--pairs 400] [--at-once 8] [--root DIR]

Each pair is two ``tests/test_torch_port_parallel_worker.py modules``
processes (gloo on the CPU), as ``spawn_ranks`` starts them; ``--root`` is
the checkout whose worker and package run (default: this one). The ranks get
both a rendezvous file (``PYDREAMER_DIST_INIT_FILE``) and a port
(``MASTER_ADDR`` / ``MASTER_PORT``), so a checkout that reads either meets.
Prints the count of each pair's exit codes (``timeout`` for a pair that
outlived ``--timeout``), then the output tail of every rank that exited
non-zero or hung and whether it had written its results. Not a
test: pytest does not collect it, and it imports no JAX.
"""

import argparse
import collections
import os
import socket
import subprocess
import sys
import tempfile
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(root: Path, scratch: Path, timeout: float):
    """One pair to its end -> (exit codes, or ("timeout",); [(rank, wrote its
    results, output tail)] for each rank that exited non-zero or hung)."""
    out_dir = Path(tempfile.mkdtemp(dir=scratch))
    common = dict(os.environ, WORLD_SIZE="2", PYTHONPATH=str(root), OMP_NUM_THREADS="1",
                  PYDREAMER_DIST_INIT_FILE=str(out_dir / f"dist_store_{uuid.uuid4().hex}"),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                  PYTHONFAULTHANDLER="1")
    logs = [out_dir / f"rank{r}.log" for r in range(2)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(root / "tests" / "test_torch_port_parallel_worker.py"),
                 "modules", str(out_dir), str(out_dir)],
                env=dict(common, RANK=str(r), LOCAL_RANK=str(r)), cwd=root, stdout=f,
                stderr=subprocess.STDOUT))
    deadline, timed_out = time.monotonic() + timeout, False
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = ("timeout",) if timed_out else tuple(p.returncode for p in procs)
    bad = [(r, (out_dir / f"rank{r}.json").exists(), logs[r].read_text().strip()[-1500:])
           for r, p in enumerate(procs) if timed_out or p.returncode]
    return codes, bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=400)
    p.add_argument("--at-once", type=int, default=8)
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--timeout", type=float, default=300.0, help="seconds a pair may take")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    with tempfile.TemporaryDirectory(prefix="stress_ranks_") as scratch:
        with ThreadPoolExecutor(args.at_once) as pool:
            results = list(pool.map(lambda _: run_pair(root, Path(scratch), args.timeout),
                                    range(args.pairs)))
    print(dict(collections.Counter(codes for codes, _ in results)))
    for _, bad in results:
        for rank, wrote, tail in bad:
            print(f"--- rank {rank} exited non-zero; wrote its results: {wrote}\n{tail}")


if __name__ == "__main__":
    main()
