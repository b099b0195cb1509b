/* C ABI of the shifu_tpu native scoring engine (shifu_scorer.cc).
 *
 * The dependency-free successor of the reference's libtensorflow_jni
 * scoring surface (shifu-tensorflow-eval/pom.xml:59-73): load an exported
 * artifact directory once, then score float rows from any language that
 * can call C — ctypes (shifu_tpu_torch/runtime/native_scorer.py), JVM FFM
 * (bindings/java/ml/shifu/shifu/tpu/ShifuTpuModel.java), or C/C++ hosts
 * including this header directly.
 *
 * Thread safety: one handle may be used from many threads concurrently
 * for compute calls (the model is immutable after load); load/free must
 * not race with in-flight computes on the same handle.
 */

#ifndef SHIFU_SCORER_H_
#define SHIFU_SCORER_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Load a packed model file — the `model.bin` inside an exported artifact
 * directory (program + weights in one blob; produced from the artifact by
 * shifu_tpu_torch/runtime/native_scorer.py pack_native(export_dir), which
 * Python/JVM hosts invoke automatically on first use).  Returns an opaque
 * handle, or NULL on failure (corrupt/mismatched files reject cleanly;
 * exceptions never cross the ABI). */
void* shifu_scorer_load(const char* model_bin_path);

/* Release a handle.  NULL is a no-op. */
void shifu_scorer_free(void* handle);

/* Model input width (feature count) / number of output heads. */
int shifu_scorer_num_features(void* handle);
int shifu_scorer_num_heads(void* handle);

/* Score n rows of num_features floats (row-major).  Writes
 * n * num_heads floats into out (scores in [0, 1]).  Returns 0 on
 * success, nonzero on error. */
int shifu_scorer_compute_batch(void* handle, const float* rows, int n,
                               float* out);

/* Single-row convenience matching the reference's
 * TensorflowModel.compute(MLData) contract (double in, double out; first
 * head).  Returns -1.0 on error — scores are sigmoids in [0, 1], so any
 * negative return means failure (the JVM binding checks score < 0). */
double shifu_scorer_compute(void* handle, const double* row);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* SHIFU_SCORER_H_ */
