"""Live strace attach runner: follow a process by name, attaching strace to
every new PID as it appears.

The offline pipeline (:mod:`traceweaver_tpu_torch.collector.strace` +
:mod:`traceweaver_tpu_torch.collector.http2`) replays logs this runner captures.
Python port of the reference's polling shell loop
(reference: src/span_collector/http2_parser/strace_runner.sh:11-26), which
busy-polls ``pgrep <name>`` and attaches
``strace -f -p <pid> -v -s 65536 -o output<tag>-attempt<i>.log`` once per
newly seen PID. Differences from the shell script, all deliberate:

- every PID returned by ``pgrep`` is attached (the script races: it re-runs
  ``pgrep`` for the attach and only ever handles the first match);
- the poll sleeps instead of spinning;
- bounded by ``--duration`` / ``--max-attempts`` so it can be supervised
  (and tested) instead of running forever.

Usage::

    python -m traceweaver_tpu_torch.collector.strace_runner search \
        --out-dir /tmp/straces --duration 60

Mirrors ``traceweaver_tpu/collector/strace_runner.py``; the port keeps its own copy.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional


def pgrep(name: str) -> List[int]:
    """PIDs whose command matches ``name`` (pgrep semantics)."""
    proc = subprocess.run(["pgrep", name], capture_output=True, text=True)
    if proc.returncode != 0:
        return []
    return [int(line) for line in proc.stdout.split() if line.strip()]


def attach_strace(pid: int, out_path: str,
                  string_limit: int = 65536) -> subprocess.Popen:
    """Attach ``strace -f -v`` to a live PID, logging to ``out_path``
    (same flags as strace_runner.sh:24)."""
    return subprocess.Popen(
        ["strace", "-f", "-p", str(pid), "-v", "-s", str(string_limit),
         "-o", out_path],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def run(process_name: str, out_dir: str = ".", tag: str = "0",
        duration: Optional[float] = None, poll_interval: float = 0.2,
        max_attempts: Optional[int] = None) -> Dict[int, str]:
    """Poll for PIDs of ``process_name``; attach strace to each new one.

    Returns {pid: log_path} for every attachment made. Runs until
    ``duration`` seconds elapse (forever when None, like the reference
    loop) or ``max_attempts`` attachments happened.
    """
    if shutil.which("strace") is None:
        raise RuntimeError("strace binary not available on this host")
    os.makedirs(out_dir, exist_ok=True)
    seen: Dict[int, str] = {}
    procs: List[subprocess.Popen] = []
    deadline = None if duration is None else time.monotonic() + duration
    attempt = 0
    try:
        while deadline is None or time.monotonic() < deadline:
            if max_attempts is None or attempt < max_attempts:
                for pid in pgrep(process_name):
                    if pid in seen:
                        continue
                    attempt += 1
                    log = os.path.join(
                        out_dir, f"output{tag}-attempt{attempt}.log")
                    try:
                        procs.append(attach_strace(pid, log))
                    except OSError as e:
                        print(f"attach to {pid} failed: {e}", file=sys.stderr)
                        continue
                    seen[pid] = log
                    print(f"Running for new pid {pid} -> {log}",
                          file=sys.stderr)
                    if max_attempts is not None and attempt >= max_attempts:
                        break
            elif deadline is None:
                # attach cap reached and no capture window requested:
                # returning here (not earlier) keeps in-flight captures
                # alive for the whole requested duration otherwise
                break
            time.sleep(poll_interval)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("process_name", help="process name to follow (pgrep)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--tag", default="0",
                    help="log name tag (strace_runner.sh $1)")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds (default: run forever)")
    ap.add_argument("--poll-interval", type=float, default=0.2)
    ap.add_argument("--max-attempts", type=int, default=None)
    args = ap.parse_args(argv)
    seen = run(args.process_name, out_dir=args.out_dir, tag=args.tag,
               duration=args.duration, poll_interval=args.poll_interval,
               max_attempts=args.max_attempts)
    print(f"attached to {len(seen)} pid(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
