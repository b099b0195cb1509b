"""The port's launcher: the `train` and `cache` commands (`cli`), the
console board (`console`), the restart supervisor (`supervisor`) and the
Kerberos ticket (`security`)."""

from .cli import EXIT_FAIL, EXIT_OK, EXIT_TIMEOUT, main
from .console import ConsoleBoard, tail_board
from .supervisor import supervise

__all__ = ["EXIT_FAIL", "EXIT_OK", "EXIT_TIMEOUT", "main", "ConsoleBoard",
           "tail_board", "supervise"]
