"""The PPC450 machine model the plan compiler ranks schedules on: the port's
own copy of the parts of ``repro.core`` it needs (ISA, dependency DAG,
greedy scheduler, in-order simulator)."""

from .dag import build_dag, critical_path_length, lower_bound  # noqa: F401
from .isa import Instr, Unit  # noqa: F401
from .scheduler import Schedule, greedy_schedule  # noqa: F401
from .simulator import simulate_inorder  # noqa: F401
