// The designs K1's tile and span kernels replaced, kept so that a caller can
// time each beside its successor on the same call (by name only: no K1 call
// goes to them). `bm3d_match_tile_slots_launch`: the tile kernel at k 128
// with four slots a lane and each candidate inserted in turn;
// `bm3d_match_span_serial_launch`: the span kernel with its run-time phase 1
// one term after another (blocks 1 and 17-32) and the same four-slot merge
// at k 128. Their source is bm3d_match.cu's; this file builds it into a
// library of its own with only these two entries, so that nvcc compiles
// them beside the main source rather than after it.
#define PNP_K1_REPLACED_DESIGNS
#include "bm3d_match.cu"
