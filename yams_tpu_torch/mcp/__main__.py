"""`python -m yams_tpu_torch.mcp [data_dir] [--device cpu]` — MCP server over
stdio (yams-mcp-server analog).

Port of yams_tpu/mcp/__main__.py; it departs from the reference only in
`--device` (default cuda), the device of the AppContext it serves.
"""

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from ..core.config import load_config
    from ..services.app import AppContext
    from .server import run_stdio_server

    p = argparse.ArgumentParser(prog="python -m yams_tpu_torch.mcp")
    p.add_argument("data_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the served app: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    app = AppContext(load_config(data_dir=args.data_dir), device=args.device)
    try:
        run_stdio_server(app)
    finally:
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
