// Other instances of csrc/likelihood_local_ctf.cu's kernel template (pixels
// a chunk, threads, blocks an SM), timed by micro/hk_candidates.py
// (--kernels hk7,hk8) beside the one the library ships.  Not part of the
// kernel library.  A plan comes from ops/likelihood.py likelihood_ctf_plan
// with the same pc and max_threads.

#include "../../csrc/likelihood_local_ctf.cu"

// variant: 0 (32, 384, 1), the shipped instance; 1 (64, 384, 1);
// 2 (32, 192, 1); 3 (64, 192, 1); 4 (32, 192, 2); 5 (16, 384, 1)
extern "C" int cand_likelihood_local_ctf_variant(const void* args, int variant, int threads,
                                                 int smem, void* stream) {
  switch (variant) {
    case 0: return launch_likelihood_local_ctf<32, 384, 1>(args, threads, smem, stream);
    case 1: return launch_likelihood_local_ctf<64, 384, 1>(args, threads, smem, stream);
    case 2: return launch_likelihood_local_ctf<32, 192, 1>(args, threads, smem, stream);
    case 3: return launch_likelihood_local_ctf<64, 192, 1>(args, threads, smem, stream);
    case 4: return launch_likelihood_local_ctf<32, 192, 2>(args, threads, smem, stream);
    case 5: return launch_likelihood_local_ctf<16, 384, 1>(args, threads, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}
