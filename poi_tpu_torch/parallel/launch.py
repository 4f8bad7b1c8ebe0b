"""Start the ranks of a job on this machine and wait for them: one process
a rank, with the variables ``torch.distributed.run`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    python -m poi_tpu_torch.parallel.launch MODULE:FUNCTION ARGS_JSON

runs one rank: it calls ``FUNCTION(**json.loads(ARGS_JSON))`` after
importing ``MODULE``. ``spawn`` starts ``world`` such processes and raises
when any exits non-zero or outlives the timeout, after ending the others,
so a failed rank fails its caller and never hangs it.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, args: dict, *, timeout: float = 600.0, cwd: str | None = None,
          env: dict | None = None, log_dir: str | None = None) -> None:
    """Run ``target`` (``module:function``) on ``world`` ranks and wait.
    Each rank's output goes to ``log_dir/rank<r>.log`` when given, else to
    this process's. Raises ``RuntimeError`` naming the ranks that failed."""
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            e = {**os.environ, **(env or {}), "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                 "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            out = None
            if log_dir is not None:
                out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
                logs.append(out)
            procs.append(subprocess.Popen([sys.executable, "-m", "poi_tpu_torch.parallel.launch", target,
                                           json.dumps(args)], cwd=cwd, env=e, stdout=out,
                                          stderr=subprocess.STDOUT if out else None))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{target}: ranks still running after {timeout:.0f} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one failed: the others may wait on it forever
            time.sleep(0.05)
        failed = {r: p.poll() for r, p in enumerate(procs) if p.poll() not in (0, None)}
        if failed or any(p.poll() is None for p in procs):
            tails = "".join(f"\n--- rank {r}'s log, last lines:\n{_tail(log_dir, r)}" for r in failed) if log_dir else ""
            raise RuntimeError(f"{target}: ranks failed (rank: exit code) {failed}" + tails)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()


def _tail(log_dir: str, rank: int, n: int = 4000) -> str:
    with open(os.path.join(log_dir, f"rank{rank}.log"), errors="replace") as f:
        return f.read()[-n:]


def main(argv: list[str]) -> int:
    module, _, function = argv[0].partition(":")
    getattr(importlib.import_module(module), function)(**json.loads(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
