"""Error taxonomy.

Mirrors the reference's ErrorCode surface (include/yams/core/types.h) so the
daemon protocol and services can report machine-readable failures, but uses
idiomatic Python exceptions instead of Result<T>.

Copied from yams_tpu/core/errors.py (the port imports
nothing of yams_tpu).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    SUCCESS = 0
    UNKNOWN = 1
    INVALID_ARGUMENT = 2
    NOT_FOUND = 3
    ALREADY_EXISTS = 4
    PERMISSION_DENIED = 5
    IO_ERROR = 6
    CORRUPTED = 7
    NOT_INITIALIZED = 8
    TIMEOUT = 9
    CANCELLED = 10
    RESOURCE_EXHAUSTED = 11
    UNSUPPORTED = 12
    SERIALIZATION = 13
    NETWORK = 14
    DATABASE = 15
    VALIDATION = 16
    INTERNAL = 17
    UNAVAILABLE = 18


class YamsError(Exception):
    """Base error carrying an ErrorCode for protocol serialization."""

    code: ErrorCode = ErrorCode.UNKNOWN

    def __init__(self, message: str = "", code: ErrorCode | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code

    @property
    def message(self) -> str:
        return str(self)


class NotFoundError(YamsError):
    code = ErrorCode.NOT_FOUND


class InvalidArgumentError(YamsError):
    code = ErrorCode.INVALID_ARGUMENT


class CorruptionError(YamsError):
    code = ErrorCode.CORRUPTED


class IOError_(YamsError):
    code = ErrorCode.IO_ERROR


class DatabaseError(YamsError):
    code = ErrorCode.DATABASE


class TimeoutError_(YamsError):
    code = ErrorCode.TIMEOUT


class NotInitializedError(YamsError):
    code = ErrorCode.NOT_INITIALIZED


class UnsupportedError(YamsError):
    code = ErrorCode.UNSUPPORTED
