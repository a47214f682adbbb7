from .ntt import Domain, intt, intt_many, ntt, ntt_many, power_table
