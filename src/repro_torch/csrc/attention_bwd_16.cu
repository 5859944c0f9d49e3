// The attention backward's dK/dV and dQ kernels at head dim 16
// (attention_bwd.cuh), built in a file of their own so that nvcc builds the
// head dims side by side.
#include "attention_bwd.cuh"

template struct repro_fa::Bwd<16>;
