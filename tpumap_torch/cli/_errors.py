"""Uniform CLI error handling: expected failures print one-line messages
instead of tracebacks (exit 2); unexpected exceptions still traceback.

The port's copy of tpumap/cli/_errors.py, unchanged."""
from __future__ import annotations

import functools
import sys


def clean_errors(main):
    @functools.wraps(main)
    def wrapper(argv=None):
        try:
            return main(argv)
        except FileNotFoundError as exc:
            sys.stderr.write(f"error: file not found: {exc.filename}\n")
            return 2
        except (ValueError, SystemExit) as exc:
            if isinstance(exc, SystemExit):
                raise
            sys.stderr.write(f"error: {exc}\n")
            return 2
        except BrokenPipeError:
            return 0
    return wrapper
