"""The daemon: an AF_UNIX socket server over one AppContext (`server.py`),
its protocol and clients, and its runtime components."""

from .client import DaemonClient
from .protocol import FrameError, read_frame, write_frame

__all__ = ["DaemonClient", "read_frame", "write_frame", "FrameError"]
