/* Native batched SHA-256 merkleization.
 *
 * The role the reference fills with native deps (eth2_hashing's ring/sha2
 * asm): the per-level hash loop of hash_tree_root over
 * large chunk planes (validator registries, block_roots vectors) without
 * per-pair Python/hashlib call overhead.
 *
 * Exposed C ABI (loaded via ctypes, no Python.h dependency):
 *   void lh_hash_pairs(const uint8_t *in, uint64_t n_pairs, uint8_t *out);
 *     in:  n_pairs * 64 bytes (concatenated 32-byte sibling pairs)
 *     out: n_pairs * 32 bytes
 *   void lh_merkleize(const uint8_t *chunks, uint64_t n, uint64_t depth,
 *                     const uint8_t *zero_hashes, uint8_t *root);
 *     Full fixed-depth merkleization with zero-subtree padding; zero_hashes
 *     is the 65*32-byte precomputed table.
 *
 * SHA-256 per FIPS 180-4.
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_compress(uint32_t state[8], const uint8_t block[64]) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)block[4 * i] << 24) | ((uint32_t)block[4 * i + 1] << 16) |
               ((uint32_t)block[4 * i + 2] << 8) | block[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ROTR(w[i - 15], 7) ^ ROTR(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = ROTR(w[i - 2], 17) ^ ROTR(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K[i] + w[i];
        uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

/* SHA-256 of exactly 64 bytes of input (the merkle-pair case): one data
 * block plus one fixed padding block. */
static void sha256_64(const uint8_t in[64], uint8_t out[32]) {
    uint32_t st[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    /* one padding block: 0x80, zeros, 64-bit big-endian bit length (512) */
    static const uint8_t pad[64] = {[0] = 0x80, [62] = 0x02};
    sha256_compress(st, in);
    sha256_compress(st, pad);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(st[i] >> 24);
        out[4 * i + 1] = (uint8_t)(st[i] >> 16);
        out[4 * i + 2] = (uint8_t)(st[i] >> 8);
        out[4 * i + 3] = (uint8_t)st[i];
    }
}

void lh_hash_pairs(const uint8_t *in, uint64_t n_pairs, uint8_t *out) {
    for (uint64_t i = 0; i < n_pairs; i++)
        sha256_64(in + 64 * i, out + 32 * i);
}

void lh_merkleize(const uint8_t *chunks, uint64_t n, uint64_t depth,
                  const uint8_t *zero_hashes, uint8_t *root) {
    if (n == 0) {
        memcpy(root, zero_hashes + 32 * depth, 32);
        return;
    }
    uint64_t cap = (n + 1) & ~1ULL;
    uint8_t *cur = (uint8_t *)malloc(cap * 32);
    memcpy(cur, chunks, n * 32);
    uint64_t count = n;
    for (uint64_t d = 0; d < depth; d++) {
        if (count & 1) {
            memcpy(cur + count * 32, zero_hashes + 32 * d, 32);
            count++;
        }
        for (uint64_t i = 0; i < count / 2; i++)
            sha256_64(cur + 64 * i, cur + 32 * i);
        count /= 2;
    }
    memcpy(root, cur, 32);
    free(cur);
}
