// The attention kernel's decode regime at head dim 128 (flash_attention.cuh),
// built in a file of its own so that nvcc builds the head dims side by side.
#include "flash_attention.cuh"

template struct repro_fa::Decode<128>;
