from .host_curve import BN254_G1, CurveParams
