"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W power limit).

The integer issue rate: each of the 132 SMs has 4 schedulers, each issuing
one warp instruction (32 lanes) a clock to the ALU or the FMA pipe, at the
1.98 GHz implied by the 67 TFLOP/s float32 rate (132 x 128 lanes x 2 per
FMA x 1.98e9): 132 x 4 x 32 x 1.98e9 = 67e12 / 2 lane-instructions a
second, the most any integer mix can reach.
"""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
