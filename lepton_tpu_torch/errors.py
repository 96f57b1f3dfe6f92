"""The errors that a request's own bytes cause, for every layer of the port
(host.py and api.py re-export them).  The device entry points raise only
REQUEST_ERRORS for what a request does wrong (api.py wraps anything else
its host stages raise on a request); the -tpu CLI and server answer such a
request from the host codec, and take any other error on the device path
for a fault of the card, which stops them."""
from __future__ import annotations

from .container.format import ContainerError
from .jpeg.decoder import JpegDecodeError
from .jpeg.imageinfo import UnsupportedJpeg
from .jpeg.parser import JpegParseError
from .jpeg.progressive import ProgressiveError
from .jpeg.recoder import RecodeError


class LeptonError(Exception):
    pass


REQUEST_ERRORS = (LeptonError, JpegParseError, JpegDecodeError,
                  UnsupportedJpeg, ProgressiveError, RecodeError,
                  ContainerError)


def request_error(i: int, e: Exception) -> Exception:
    """e when it is one of REQUEST_ERRORS, else a LeptonError naming
    request i and e (its message kept, so exitcodes.classify still reads
    it)."""
    return e if isinstance(e, REQUEST_ERRORS) else LeptonError(
        f"request {i}: {type(e).__name__}: {e}")
