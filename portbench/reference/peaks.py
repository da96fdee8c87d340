"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit). They are the data sheet's figures, not
measurements of the card a run gets."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12
#: bf16 / fp16 tensor-core rate, dense, FLOP/s
BF16_FLOPS = 989e12
