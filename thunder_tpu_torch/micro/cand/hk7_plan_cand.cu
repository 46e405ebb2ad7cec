// Other instances of csrc/symmetrize_ft.cu's kernel template (blocks of 512
// threads an SM the registers must allow), timed by micro/hk_candidates.py
// (--kernels hk7,hk8) beside the one the library ships, and the orbit form
// with other brick edges.  Not part of the kernel library.

#include "../../csrc/symmetrize_ft.cu"

// min_blocks: 1, 2, 3 or 4
extern "C" int cand_symmetrize_ft_variant(const void* args, int min_blocks, int n_grids,
                                          int threads, int smem, void* stream) {
  switch (min_blocks) {
    case 1: return launch_symmetrize_ft<1>(args, n_grids, threads, smem, stream);
    case 2: return launch_symmetrize_ft<2>(args, n_grids, threads, smem, stream);
    case 3: return launch_symmetrize_ft<3>(args, n_grids, threads, smem, stream);
    case 4: return launch_symmetrize_ft<4>(args, n_grids, threads, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}
