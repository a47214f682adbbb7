from .params import BN254_FQ, BN254_FR, LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldParams, int_to_limbs, limbs_to_int
from . import mont
