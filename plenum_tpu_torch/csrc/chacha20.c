/* ChaCha20 (RFC 8439 §2.3-2.4) for the node and client stacks' channel
 * cipher, crypto/pure_channel_crypto.py::ChaCha20Poly1305.
 *
 * Fills the role OpenSSL plays for the reference through `cryptography`
 * (plenum_tpu/network/crypto_channel.py): the wire encrypts every frame,
 * and the keystream is nearly all of the cipher's work (Poly1305 stays in
 * Python, one big-integer step per 16 bytes). Python falls back to its
 * own keystream loop when no C compiler is available; that loop is the
 * reference the tests hold this file against, with `cryptography`.
 */
#include <stddef.h>
#include <stdint.h>

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

static inline uint32_t load32_le(const uint8_t *p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16
        | (uint32_t)p[3] << 24;
}

#define QR(a, b, c, d)                                   \
    a += b; d ^= a; d = rotl32(d, 16);                   \
    c += d; b ^= c; b = rotl32(b, 12);                   \
    a += b; d ^= a; d = rotl32(d, 8);                    \
    c += d; b ^= c; b = rotl32(b, 7);

/* out[0, len) = in[0, len) XOR the keystream of (key, nonce) from block
 * `counter` on; in and out may be the same buffer. */
void chacha20_xor(const uint8_t *key, uint32_t counter, const uint8_t *nonce,
                  const uint8_t *in, uint8_t *out, size_t len) {
    uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u};
    for (int i = 0; i < 8; i++) s[4 + i] = load32_le(key + 4 * i);
    for (int i = 0; i < 3; i++) s[13 + i] = load32_le(nonce + 4 * i);
    for (size_t off = 0; off < len; off += 64, counter++) {
        uint32_t x[16];
        s[12] = counter;
        for (int i = 0; i < 16; i++) x[i] = s[i];
        for (int r = 0; r < 10; r++) {
            QR(x[0], x[4], x[8], x[12]) QR(x[1], x[5], x[9], x[13])
            QR(x[2], x[6], x[10], x[14]) QR(x[3], x[7], x[11], x[15])
            QR(x[0], x[5], x[10], x[15]) QR(x[1], x[6], x[11], x[12])
            QR(x[2], x[7], x[8], x[13]) QR(x[3], x[4], x[9], x[14])
        }
        uint8_t ks[64];
        for (int i = 0; i < 16; i++) {
            uint32_t w = x[i] + s[i];
            ks[4 * i] = (uint8_t)w;
            ks[4 * i + 1] = (uint8_t)(w >> 8);
            ks[4 * i + 2] = (uint8_t)(w >> 16);
            ks[4 * i + 3] = (uint8_t)(w >> 24);
        }
        size_t n = len - off < 64 ? len - off : 64;
        for (size_t i = 0; i < n; i++) out[off + i] = in[off + i] ^ ks[i];
    }
}
