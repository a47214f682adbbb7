from .context import Context, FlexGate
from .builder import CircuitBuilder, Pinning
from .range import RangeChip
