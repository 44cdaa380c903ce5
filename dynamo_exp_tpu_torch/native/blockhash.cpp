// Chained block hashing for token sequences: the host hot path under the
// KV-aware router, the prefix-reuse cache and the G3 store's page keys.
//
// Counterpart of dynamo_exp_tpu/native/blockhash.cpp, the same bytes of
// algorithm: a splitmix64-finalizer chain that the Python mirror in
// dynamo_exp_tpu_torch/tokens.py follows EXACTLY. Equal inputs give equal
// hashes in either package and either implementation, or router and
// worker processes would disagree on prefix identity.
//
// Layout contract (mirrored in Python — change both or neither):
//   mix(x)            = splitmix64 finalizer
//   local(toks, seed) = mix(seed ^ LOCAL_TAG) folded over
//                       mix(h ^ (tok + GOLDEN)), closed with mix(h ^ n)
//   chain(parent?, local, seed)
//                     = mix(seed ^ CHAIN_TAG) -> mix(h ^ parent-or-TAG)
//                       -> mix(h ^ local)

#include <cstdint>
#include <cstddef>

static const uint64_t GOLDEN = 0x9e3779b97f4a7c15ULL;
static const uint64_t LOCAL_TAG = 0x00b10c4a54aa17e5ULL;
static const uint64_t CHAIN_TAG = 0x00c4a18a54bb28f6ULL;
static const uint64_t NO_PARENT_TAG = 0x006e6f5061726e74ULL;

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xbf58476d1ce4e5b9ULL;
    x ^= x >> 27;
    x *= 0x94d049bb133111ebULL;
    x ^= x >> 31;
    return x;
}

extern "C" {

uint64_t dx_block_hash(const uint32_t* toks, uint64_t n, uint64_t seed) {
    uint64_t h = mix64(seed ^ LOCAL_TAG);
    for (uint64_t i = 0; i < n; ++i) {
        h = mix64(h ^ ((uint64_t)toks[i] + GOLDEN));
    }
    return mix64(h ^ n);
}

uint64_t dx_chain_hash(uint64_t parent, int has_parent, uint64_t local,
                       uint64_t seed) {
    uint64_t h = mix64(seed ^ CHAIN_TAG);
    h = mix64(h ^ (has_parent ? parent : NO_PARENT_TAG));
    return mix64(h ^ local);
}

// Sequence hashes for every complete block; returns the block count.
// seq_out must hold n / block entries.
uint64_t dx_seq_hashes(const uint32_t* toks, uint64_t n, uint64_t block,
                       uint64_t seed, int has_parent, uint64_t parent,
                       uint64_t* seq_out) {
    uint64_t nb = block ? n / block : 0;
    for (uint64_t b = 0; b < nb; ++b) {
        uint64_t local = dx_block_hash(toks + b * block, block, seed);
        parent = dx_chain_hash(parent, has_parent, local, seed);
        has_parent = 1;
        seq_out[b] = parent;
    }
    return nb;
}

}  // extern "C"
