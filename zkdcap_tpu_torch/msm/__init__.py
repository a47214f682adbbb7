from .pippenger import msm, msm_device, msm_host, msm_ladder, msm_many_host
