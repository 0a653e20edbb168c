"""The chip's peaks that every roofline share is held against (one NVIDIA
H100 SXM5 80 GB at its 700 W limit; a card set lower runs slower, so each
traced run prints the card's power limit beside them).

HBM_BYTES_PER_S   3.35e12: NVIDIA H100 Tensor Core GPU data sheet, SXM5,
                  HBM3 bandwidth 3.35 TB/s.
INT32_MULADD_PER_S  132 SMs x 64 INT32 lanes per SM and clock (CUDA C++
                  Programming Guide, "Arithmetic Instructions" throughput
                  table: 32-bit integer multiply-add, compute capability
                  9.0) x the 1980 MHz boost clock = 1.6727e13 a second.
MULADDS_PER_MONT_MUL  264 32-bit multiply-adds a 256-bit Montgomery
                  product (CIOS on 8 words: 8 rows of 2 x 16 half-products
                  and a quotient digit).
"""

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, BOOST_CLOCK_HZ = 132, 64, 1.98e9
INT32_MULADD_PER_S = SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ
MULADDS_PER_MONT_MUL = 264
