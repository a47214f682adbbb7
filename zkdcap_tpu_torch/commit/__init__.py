from .srs import SRS, gen_srs
from .kzg import ParamsKZG
