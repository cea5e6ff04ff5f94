from .sim import (awgn, bpsk, ber, simulate, theoretical_ber,  # noqa: F401
                  ebn0_distance_metric)
