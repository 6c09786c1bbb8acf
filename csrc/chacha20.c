/* ChaCha20 stream generator (RFC 7539 block function).
 *
 * Native counterpart of the reference's ChaCha20Stream CSPRNG dependency
 * (/root/reference/src/ring/sampler.jl uses ChaChaCiphers.ChaCha20Stream
 * for all secret material).  Compiled to a shared object and driven via
 * ctypes from mktfhe/native/chacha.py; a pure-Python fallback keeps
 * the package importable without a C toolchain.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define ROTL32(v, c) (((v) << (c)) | ((v) >> (32 - (c))))

#define QR(a, b, c, d)                                                         \
    a += b; d ^= a; d = ROTL32(d, 16);                                         \
    c += d; b ^= c; b = ROTL32(b, 12);                                         \
    a += b; d ^= a; d = ROTL32(d, 8);                                          \
    c += d; b ^= c; b = ROTL32(b, 7);

static void chacha20_block(const uint32_t key[8], const uint32_t nonce[3],
                           uint32_t counter, uint32_t out[16]) {
    static const uint32_t sigma[4] = {0x61707865u, 0x3320646eu, 0x79622d32u,
                                      0x6b206574u};
    uint32_t x[16];
    int i;
    for (i = 0; i < 4; i++) x[i] = sigma[i];
    for (i = 0; i < 8; i++) x[4 + i] = key[i];
    x[12] = counter;
    for (i = 0; i < 3; i++) x[13 + i] = nonce[i];

    uint32_t s[16];
    memcpy(s, x, sizeof(s));
    for (i = 0; i < 10; i++) {
        QR(s[0], s[4], s[8], s[12])
        QR(s[1], s[5], s[9], s[13])
        QR(s[2], s[6], s[10], s[14])
        QR(s[3], s[7], s[11], s[15])
        QR(s[0], s[5], s[10], s[15])
        QR(s[1], s[6], s[11], s[12])
        QR(s[2], s[7], s[8], s[13])
        QR(s[3], s[4], s[9], s[14])
    }
    for (i = 0; i < 16; i++) out[i] = s[i] + x[i];
}

/* Fill `out` with nwords uint32 keystream words, starting at block
 * `counter`.  Returns the next counter value. */
uint32_t chacha20_stream(const uint8_t key[32], const uint8_t nonce[12],
                         uint32_t counter, uint32_t *out, size_t nwords) {
    uint32_t k[8], n[3], block[16];
    size_t i, produced = 0;
    memcpy(k, key, 32);
    memcpy(n, nonce, 12);
    while (produced < nwords) {
        chacha20_block(k, n, counter++, block);
        size_t take = nwords - produced;
        if (take > 16) take = 16;
        for (i = 0; i < take; i++) out[produced + i] = block[i];
        produced += take;
    }
    return counter;
}
