"""`python -m yams_tpu_torch.daemon [data_dir] [--device cuda|cpu]` — run
the port's daemon in the foreground on the card (the default) or the CPU."""

import argparse
import faulthandler
import signal

from ..core.config import load_config
from .server import run_daemon

if __name__ == "__main__":
    # SIGUSR2 dumps all thread stacks to stderr (the daemon log) — the
    # operator's hung-daemon diagnostic (reference: doctor + tracing tier)
    faulthandler.register(signal.SIGUSR2, all_threads=True)
    p = argparse.ArgumentParser(prog="python -m yams_tpu_torch.daemon")
    p.add_argument("data_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = p.parse_args()
    run_daemon(load_config(data_dir=args.data_dir), device=args.device)
