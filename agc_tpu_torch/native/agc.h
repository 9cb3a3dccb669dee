/*
 * agc-tpu C API — decompression-only access to AGC archives.
 *
 * ABI-compatible with the reference AGC library's C interface
 * (reference: src/lib-cxx/agc-api.h:119-203): existing C clients can link
 * against libagcnative.so unchanged.
 *
 * Thread usage: one agc_t handle may be shared across threads for reads.
 */

#ifndef AGC_TPU_C_API_H
#define AGC_TPU_C_API_H

#ifdef __cplusplus
extern "C" {
#endif

typedef struct agc_t agc_t;

/* Open an archive. prefetching=1 buffers the whole file in memory.
 * Returns NULL on error. */
agc_t* agc_open(char* fn, int prefetching);

/* Close and free the handle. Returns 0 on success, -1 on error. */
int agc_close(agc_t* agc);

/* Length of a contig; sample may be NULL if the contig name is unique.
 * Returns <0 on error. */
int agc_get_ctg_len(const agc_t* agc, const char* sample, const char* name);

/* Extract [start, end] (inclusive, -1/-1 for whole contig) into buf as a
 * NUL-terminated ASCII sequence; the caller allocates
 * agc_get_ctg_len(...)+1 bytes. Returns the sequence length, <0 on
 * error. */
int agc_get_ctg_seq(const agc_t* agc, const char* sample, const char* name,
                    int start, int end, char* buf);

/* Number of samples in the archive, -1 on error. */
int agc_n_sample(const agc_t* agc);

/* Number of contigs in a sample, -1 on error. */
int agc_n_ctg(const agc_t* agc, const char* sample);

/* Name of the reference (first) sample; free with agc_string_destroy. */
char* agc_reference_sample(const agc_t* agc);

/* NULL-terminated array of sample names; free with agc_list_destroy. */
char** agc_list_sample(const agc_t* agc, int* n_sample);

/* NULL-terminated array of contig names; free with agc_list_destroy. */
char** agc_list_ctg(const agc_t* agc, const char* sample, int* n_ctg);

int agc_list_destroy(char** list);
int agc_string_destroy(char* sample);

#ifdef __cplusplus
}
#endif

#endif /* AGC_TPU_C_API_H */
