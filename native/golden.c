/* Host-side golden model of the fixed-point kernels.
 *
 * An independent, scalar C implementation of the bit-exact integer
 * semantics (cossin DDS, atan2, Q-format multiply, DF1/wide/dither
 * biquad steps, PLL update) used to cross-validate the JAX/Pallas
 * implementations — this package's version of the reference's
 * cross-implementation equivalence tests (SURVEY.md §4.4).
 *
 * Semantics follow the reference algorithms:
 *   cossin:  src/cossin.rs:14-67 (octant fold, 128-entry midpoint LUT,
 *            first-order interpolation)
 *   atan2:   src/atan2.rs:12-82 (octant fold, reciprocal LUT + Newton,
 *            11th-order odd polynomial)
 *   biquad:  src/iir/biquad.rs:366-538 (DF1, wide, dither)
 *
 * Built as a plain shared library, loaded with ctypes.
 */

#include <stdint.h>
#include <math.h>
#include <string.h>

/* ---------- LUT generation (build.rs:8-67) ---------- */

static uint32_t cossin_lut[128];
static uint32_t atan2_recip_base[16];
static int32_t atan2_recip_slope[16];
static int luts_ready = 0;

static double round_half_away(double x) {
    return x >= 0.0 ? floor(x + 0.5) : ceil(x - 0.5);
}

static void init_luts(void) {
    if (luts_ready) return;
    const double amp = 65535.0;
    for (int i = 0; i < 128; i++) {
        double z = (M_PI / 4.0) * ((i + 0.5) / 128.0);
        uint32_t c = (uint32_t)round_half_away((cos(z) * 2.0 - 1.0) * amp - 1.0);
        uint32_t s = (uint32_t)round_half_away(sin(z) * amp);
        cossin_lut[i] = c + (s << 16);
    }
    const double q31 = 2147483648.0;
    for (int i = 0; i < 16; i++) {
        double x0 = 1.0 + i / 16.0;
        double x1 = 1.0 + (i + 1) / 16.0;
        atan2_recip_base[i] = (uint32_t)round_half_away(q31 / x0);
        atan2_recip_slope[i] = (int32_t)round_half_away((1.0 / x1 - 1.0 / x0) * q31);
    }
    luts_ready = 1;
}

/* ---------- cossin ---------- */

void golden_cossin(const int32_t *phase, int32_t *cos_out, int32_t *sin_out,
                   int64_t n) {
    init_luts();
    const int align_msb = 15;
    const int depth = 7;
    const int32_t pi4 = (int32_t)(M_PI / 4.0 * 65536.0); /* trunc */
    for (int64_t k = 0; k < n; k++) {
        int32_t p = phase[k];
        uint32_t octant = (uint32_t)p;
        if (octant & (1u << 29)) p = ~p;
        p = (int32_t)((((uint32_t)p) << 3) >> (32 - depth - align_msb));
        uint32_t lookup = cossin_lut[p >> align_msb];
        p &= (1 << align_msb) - 1;
        p -= 1 << (align_msb - 1);
        int32_t dphi = (p * pi4) >> 16;
        int32_t c = (int32_t)(uint16_t)lookup + (1 << 16);
        int32_t s = (int32_t)(lookup >> 16);
        int32_t dcos = (s * dphi) >> depth;
        int32_t dsin = (c * dphi) >> (depth + 1);
        c = (c << (align_msb - 1)) - dcos;
        s = (s << align_msb) + dsin;
        octant ^= octant >> 1;
        if (octant & (1u << 29)) { int32_t t = c; c = s; s = t; }
        if (octant & (1u << 30)) c = -c;
        if (octant & (1u << 31)) s = -s;
        cos_out[k] = c;
        sin_out[k] = s;
    }
}

/* ---------- atan2 ---------- */

static uint32_t mul_q31(uint32_t x, uint32_t y) {
    return (uint32_t)(((uint64_t)x * (uint64_t)y) >> 31);
}

static uint32_t divi(uint32_t y, uint32_t x) {
    if (x == 0) return 0;
    int shift = __builtin_clz(x);
    y <<= shift;
    x <<= shift;
    const int frac_bits = 27;
    uint32_t rem = x & ((1u << frac_bits) - 1);
    uint32_t idx = (x << 1) >> (1 + frac_bits);
    uint32_t base = atan2_recip_base[idx];
    int32_t slope = atan2_recip_slope[idx];
    uint32_t step = (uint32_t)(((int64_t)slope * (int64_t)rem) >> frac_bits);
    uint32_t r0 = base + step;
    return mul_q31(y, mul_q31(r0, (uint32_t)(-(int32_t)mul_q31(x, r0))));
}

static uint32_t atani(uint32_t x) {
    static const int32_t coeffs[6] = {
        0x0517c2cd, -0x06c6496b, 0x0fbdb021,
        -0x25b32e0a, 0x43b34c81, -0x3bc823dd,
    };
    int32_t x2 = (int32_t)(((int64_t)x * (int64_t)x) >> 32);
    int32_t r = 0;
    for (int i = 5; i >= 0; i--) {
        r = (int32_t)((((int64_t)r * (int64_t)x2) >> 32)) + coeffs[i];
    }
    return (uint32_t)((((int64_t)r) * (int64_t)x) >> 28);
}

static int32_t sat_neg(int32_t v) {
    return v == INT32_MIN ? INT32_MAX : -v;
}

void golden_atan2(const int32_t *y_in, const int32_t *x_in, int32_t *out,
                  int64_t n) {
    init_luts();
    for (int64_t k = 0; k < n; k++) {
        int32_t y = y_in[k], x = x_in[k];
        uint32_t key = 0;
        if (y < 0) { y = sat_neg(y); key ^= 0xffffffffu; }
        if (x < 0) { x = sat_neg(x); key ^= 0x7fffffffu; }
        if (y > x) { int32_t t = y; y = x; x = t; key ^= 0x3fffffffu; }
        uint32_t r = atani(divi((uint32_t)y, (uint32_t)x));
        out[k] = (int32_t)(r ^ key);
    }
}

/* ---------- fixed-point biquad steps ---------- */

/* DF1: state = [x1, x2, y1, y2] per channel */
void golden_biquad_df1_q(const int32_t ba[5], int f, int32_t *state,
                         const int32_t *x, int32_t *y, int64_t n) {
    int32_t x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    for (int64_t k = 0; k < n; k++) {
        int64_t acc = (int64_t)ba[0] * x[k] + (int64_t)ba[1] * x1 +
                      (int64_t)ba[2] * x2 + (int64_t)ba[3] * y1 +
                      (int64_t)ba[4] * y2;
        int32_t y0 = (int32_t)(acc >> f);
        x2 = x1; x1 = x[k];
        y2 = y1; y1 = y0;
        y[k] = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
}

/* wide: x state i32[2], y state i64[2] (biquad.rs:456-472) */
void golden_biquad_df1_wide(const int32_t ba[5], int f, int32_t *xs,
                            int64_t *ys, const int32_t *x, int32_t *y,
                            int64_t n) {
    for (int64_t k = 0; k < n; k++) {
        int64_t acc = (int64_t)ba[0] * x[k] + (int64_t)ba[1] * xs[0] +
                      (int64_t)ba[2] * xs[1];
        xs[1] = xs[0]; xs[0] = x[k];
        acc += ((int64_t)(uint32_t)ys[0] * (int64_t)ba[3]) >> 32;
        acc += (int64_t)(int32_t)(ys[0] >> 32) * (int64_t)ba[3];
        acc += ((int64_t)(uint32_t)ys[1] * (int64_t)ba[4]) >> 32;
        acc += (int64_t)(int32_t)(ys[1] >> 32) * (int64_t)ba[4];
        acc <<= 32 - f;
        ys[1] = ys[0]; ys[0] = acc;
        y[k] = (int32_t)(acc >> 32);
    }
}

/* dither: DF1 + u32 error feedback (biquad.rs:511-530) */
void golden_biquad_df1_dither(const int32_t ba[5], int f, int32_t *state,
                              uint32_t *e, const int32_t *x, int32_t *y,
                              int64_t n) {
    int32_t x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    uint32_t err = *e;
    for (int64_t k = 0; k < n; k++) {
        int64_t acc = (int64_t)err + (int64_t)ba[0] * x[k] +
                      (int64_t)ba[1] * x1 + (int64_t)ba[2] * x2 +
                      (int64_t)ba[3] * y1 + (int64_t)ba[4] * y2;
        acc <<= 32 - f;
        err = ((uint32_t)acc) >> (32 - f);
        int32_t y0 = (int32_t)(acc >> 32);
        x2 = x1; x1 = x[k];
        y2 = y1; y1 = y0;
        y[k] = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
    *e = err;
}

/* clamp: DF1 with offset + output clamp fed back (biquad.rs:394-404) */
void golden_biquad_df1_clamp(const int32_t ba[5], int f, int32_t u,
                             int32_t lo, int32_t hi, int32_t *state,
                             const int32_t *x, int32_t *y, int64_t n) {
    int32_t x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    for (int64_t k = 0; k < n; k++) {
        int64_t acc = (int64_t)ba[0] * x[k] + (int64_t)ba[1] * x1 +
                      (int64_t)ba[2] * x2 + (int64_t)ba[3] * y1 +
                      (int64_t)ba[4] * y2;
        int32_t y0 = (int32_t)(acc >> f) + u;
        if (y0 < lo) y0 = lo;
        if (y0 > hi) y0 = hi;
        x2 = x1; x1 = x[k];
        y2 = y1; y1 = y0;
        y[k] = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
}

/* Q16<13>: i16 storage, i32 accumulator (tests/embedded/README.md:62).
 * The 5-product i32 sum can wrap; build with -fwrapv for two's
 * complement semantics matching the release-mode reference. */
void golden_biquad_df1_q16(const int16_t ba[5], int f, int16_t *state,
                           const int16_t *x, int16_t *y, int64_t n) {
    int16_t x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    for (int64_t k = 0; k < n; k++) {
        int32_t acc = (int32_t)ba[0] * x[k] + (int32_t)ba[1] * x1 +
                      (int32_t)ba[2] * x2 + (int32_t)ba[3] * y1 +
                      (int32_t)ba[4] * y2;
        int16_t y0 = (int16_t)(acc >> f);
        x2 = x1; x1 = x[k];
        y2 = y1; y1 = y0;
        y[k] = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
}

/* Q64<61>: i64 storage, i128 accumulator (tests/embedded/README.md:63). */
void golden_biquad_df1_q64(const int64_t ba[5], int f, int64_t *state,
                           const int64_t *x, int64_t *y, int64_t n) {
    int64_t x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    for (int64_t k = 0; k < n; k++) {
        __int128 acc = (__int128)ba[0] * x[k] + (__int128)ba[1] * x1 +
                       (__int128)ba[2] * x2 + (__int128)ba[3] * y1 +
                       (__int128)ba[4] * y2;
        int64_t y0 = (int64_t)(acc >> f);
        x2 = x1; x1 = x[k];
        y2 = y1; y1 = y0;
        y[k] = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
}

/* ---------- PLL (pll.rs:90-107) ---------- */

/* st32 = [clamp_x0, clamp_state, z0, y0, y]; st64 = [f0, f] */
void golden_pll(const int32_t ba[3], int32_t *st32, int64_t *st64,
                const int32_t *x, int32_t *y_out, int64_t n) {
    int32_t cx0 = st32[0], ccl = st32[1], z0 = st32[2], y0 = st32[3],
            y = st32[4];
    int64_t f0 = st64[0], f = st64[1];
    for (int64_t k = 0; k < n; k++) {
        y = y + (int32_t)(f >> 32); /* NCO advance by frequency hi word */
        int32_t xi = x[k] + y;
        /* wrap-clamped phase error (unwrap.rs:73-80, 184-194) */
        int32_t delta = xi - cx0;
        int32_t wrap = (delta >= 0) - (xi >= cx0);
        ccl += wrap;
        if (ccl > 1) ccl = 1;
        if (ccl < -1) ccl = -1;
        int32_t ze = ccl < 0 ? INT32_MIN : (ccl > 0 ? INT32_MAX : xi);
        cx0 = xi;
        int32_t z0n = ze >> 1;
        int32_t y0n = z0n + z0; /* Nyquist zero */
        /* lead-lag with wide state + first-order noise shaping */
        int64_t t = (int64_t)ba[0] * y0n + (int64_t)ba[1] * y0 +
                    (int64_t)ba[2] * (int32_t)(f0 >> 32) +
                    (((int64_t)(uint32_t)f0 * (int64_t)ba[2]) >> 32);
        f0 += t;
        f += f0; /* DC pole */
        z0 = z0n;
        y0 = y0n;
        y_out[k] = y;
    }
    st32[0] = cx0; st32[1] = ccl; st32[2] = z0; st32[3] = y0; st32[4] = y;
    st64[0] = f0; st64[1] = f;
}

/* ---------- Q-format multiply ---------- */

void golden_q_mul(const int32_t *a, const int32_t *b, int f, int32_t *out,
                  int64_t n) {
    for (int64_t k = 0; k < n; k++) {
        out[k] = (int32_t)(((int64_t)a[k] * (int64_t)b[k]) >> f);
    }
}

/* ---------- normal form (Rader-Gold coupled SOS, normal.rs:38-58) ---------- */

/* state = [x1, x2, y0, y1]; y0/y1 are the rotating I/Q components.
 * Two truncating-shift quantizations per sample, both reading the OLD
 * rotating state (matches idsp_tpu.filters.normal.step_q). */
void golden_normal_q(const int32_t b[3], const int32_t p[2], int f,
                     int32_t *state, const int32_t *x, int32_t *y_out,
                     int64_t n) {
    int32_t x1 = state[0], x2 = state[1], y0 = state[2], y1 = state[3];
    for (int64_t k = 0; k < n; k++) {
        int32_t x0 = x[k];
        int64_t acc1 = (int64_t)b[0] * x0 + (int64_t)b[1] * x1 +
                       (int64_t)b[2] * x2 + (int64_t)p[0] * y1 -
                       (int64_t)p[1] * y0;
        int32_t y1n = (int32_t)(acc1 >> f);
        int64_t acc0 = (int64_t)p[1] * y1 + (int64_t)p[0] * y0;
        int32_t y0n = (int32_t)(acc0 >> f);
        x2 = x1; x1 = x0; y0 = y0n; y1 = y1n;
        y_out[k] = y0n;
    }
    state[0] = x1; state[1] = x2; state[2] = y0; state[3] = y1;
}

/* ---------- RPLL (rpll.rs:47-77) ---------- */

/* st = [x_prev, ff, f, y] (ff/f are u32 bit patterns).  valid[k] marks
 * update cycles that carry a timestamp; the phase always advances.
 * Mirrors idsp_tpu.filters.rpll.step (masked-stream formulation). */
void golden_rpll(int dt2, int sf, int sp, int32_t *st, const int32_t *x_in,
                 const uint8_t *valid, int32_t *phase_out, int32_t *freq_out,
                 int64_t n) {
    int32_t x_prev = st[0];
    uint32_t ff = (uint32_t)st[1];
    uint32_t f = (uint32_t)st[2];
    int32_t y = st[3];
    uint32_t p_ref = (uint32_t)(((uint64_t)1 << (32 + dt2 - sf)) &
                                0xFFFFFFFFu);
    uint32_t dt_mask = (uint32_t)((1u << dt2) - 1u);
    for (int64_t k = 0; k < n; k++) {
        int32_t x = x_in[k];
        y = (int32_t)((uint32_t)y + f); /* advance phase */
        int32_t dx = (int32_t)((uint32_t)x - (uint32_t)x_prev);
        /* frequency lock: reference phase over dx, rounded half up */
        uint64_t p_sig64 = (uint64_t)ff * (uint64_t)(uint32_t)dx;
        uint32_t p_sig =
            (uint32_t)((p_sig64 + ((uint64_t)1 << (sf - 1))) >> sf);
        uint32_t ff2 = ff + (p_ref - p_sig);
        /* phase lock: predicted "now" phase with the pre-update f */
        uint32_t dt = (uint32_t)(-(uint32_t)x) & dt_mask;
        int32_t y_ref = (int32_t)((f >> dt2) * dt);
        int32_t dy = (int32_t)((uint32_t)y_ref - (uint32_t)y) >> (sp - dt2);
        uint32_t f2 = ff2 + (uint32_t)dy;
        if (valid[k]) { x_prev = x; ff = ff2; f = f2; }
        phase_out[k] = y;
        freq_out[k] = (int32_t)f;
    }
    st[0] = x_prev; st[1] = (int32_t)ff; st[2] = (int32_t)f; st[3] = y;
}
