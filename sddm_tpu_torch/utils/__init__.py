from .config import ConfigParser
from .logging import setup_logging
from .util import read_json, write_json

__all__ = ["ConfigParser", "read_json", "write_json", "setup_logging"]
