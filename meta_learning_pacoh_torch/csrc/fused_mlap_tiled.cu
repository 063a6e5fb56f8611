// The fused PACOH-MLAP kernel B8 (fused_mlap.cuh), tiled: each cluster's task
// posteriors in device memory and each CTA's tasks walked in tiles (the plan's
// tile is below ceil(T / C)), for task counts whose rows do not fit in a CTA.
// Replaces meta_learning_pacoh_tpu/ops/pallas/fused_mlap_kernel.py with
// fused_mlap.cu.

#include "fused_mlap.cuh"

extern "C" int pacoh_fused_mlap_tiled(
    float* loc, float* lsc, float* qm, float* qt, float* nu, float* m_loc, float* m_lsc,
    float* m_qm, float* m_qt, float* m_nu, float* v_loc, float* v_lsc, float* v_qm, float* v_qt,
    float* v_nu, const float* x, const float* y, const float* mask, const float* counts,
    const float* eps, const float* prior_loc, const float* prior_scale, const int* offs,
    float* kl_buf, float* q_buf, float* s_buf, float* t_buf, float* out, int s, int t, int n,
    int d, int h, int l, int p, int n_steps, int meta_test, int c, int hs, int tile, float step0,
    float lr_main, float lr_post, float u_scale, float tkw, float mkw, float neg_log_delta,
    float log_n_tasks, float cm2, float sum_log_sigma_p, int device, void* stream) {
  return mlap_launch<true>(loc, lsc, qm, qt, nu, m_loc, m_lsc, m_qm, m_qt, m_nu, v_loc, v_lsc,
                           v_qm, v_qt, v_nu, x, y, mask, counts, eps, prior_loc, prior_scale,
                           offs, kl_buf, q_buf, s_buf, t_buf, out, s, t, n, d, h, l, p, n_steps,
                           meta_test, c, hs, tile, step0, lr_main, lr_post, u_scale, tkw, mkw,
                           neg_log_delta, log_n_tasks, cm2, sum_log_sigma_p, device, stream);
}

// Resident clusters of c CTAs of the kernel at this configuration, into *out
// (cudaOccupancyMaxActiveClusters).
extern "C" int pacoh_fused_mlap_tiled_clusters(int t, int n, int d, int h, int l, int p, int c,
                                         int hs, int tile, int* out, int device, void* stream) {
  (void)stream;
  return mlap_capacity<true>(t, n, d, h, l, p, c, hs, tile, out, device);
}
