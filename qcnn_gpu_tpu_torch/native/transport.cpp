// Native host side of the packed wire transports (engine/packed.py).
//
// The port's own copy of qcnn_gpu_tpu/native/transport.cpp, byte for byte
// the same functions. The duplex H2D packer classifies 256-px flat blocks
// of the temporal delta (zero / nibble / raw) and fills the bucketed wire
// buffers; the D2H decoders expand the 4-bit residual nibbles and apply
// the exact exception list, or integrate the gathered int8
// residual-delta blocks; the predictor marks the blocks the receptive
// radius lets a change reach. Each is bit-identical to the NumPy function
// in engine/packed.py that defines its semantics (the tests hold them
// equal). One pass over the raster each instead of NumPy's temporaries:
// in the pipelined loop these run on the producer and fetcher threads,
// so host time subtracts directly from transfer overlap.
//
// Reference parity: the reference's host loop does raw memcpys
// (kernel.cu:89-101); the packed transports serve link-bound streams.

#include <cstdint>
#include <cstring>

namespace {
constexpr int64_t BLK = 256;
}

extern "C" {

// Pass 1: classify each 256-px block of d = x - ref.
//   cls[nb]: 0 = all-zero, 1 = nibble, 2 = raw (dense exceptions)
//   counts[4] = {n_raw_blocks, n_nib_blocks, n_pointwise_exceptions,
//                n_total_exceptions}  (the last feeds exc_frac stats)
// Tail block (n % 256) is padded with zero deltas, matching NumPy.
void duplex_classify(const uint8_t* x, const uint8_t* ref, int64_t n,
                     uint8_t* cls, int64_t* counts) {
  int64_t nb = (n + BLK - 1) / BLK;
  int64_t n_raw = 0, n_nib = 0, n_exc = 0, n_exc_all = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t lo = b * BLK, hi = lo + BLK < n ? lo + BLK : n;
    int exc = 0, exc127 = 0;
    bool nz = false;
    for (int64_t i = lo; i < hi; ++i) {
      int d = (int)x[i] - (int)ref[i];
      nz |= d != 0;
      exc += (d > 7) | (d < -8);
      exc127 += (d > 127) | (d < -128);
    }
    n_exc_all += exc;
    if (!nz) {
      cls[b] = 0;
    } else if ((int64_t)exc * 6 >= BLK + 4) {  // int8 raw beats pointwise
      cls[b] = 2;
      ++n_raw;
      n_exc += exc127;  // raw blocks: only |d|>127 rides the list
    } else {
      cls[b] = 1;
      ++n_nib;
      n_exc += exc;
    }
  }
  counts[0] = n_raw;
  counts[1] = n_nib;
  counts[2] = n_exc;
  counts[3] = n_exc_all;
}

// Pass 2: fill the python-allocated bucketed buffers. Buffers arrive
// pre-padded (idx arrays = sentinel, value arrays zeroed); this writes
// only the live prefixes, in block order (matching np.nonzero).
void duplex_fill(const uint8_t* x, const uint8_t* ref, int64_t n,
                 const uint8_t* cls,
                 int32_t* nib_idx, uint8_t* nib,       // [kn], [kn*128]
                 int32_t* raw_idx, int8_t* raw_val,    // [kr], [kr*256]
                 int32_t* exc_idx, int16_t* exc_val) { // [ke], [ke]
  int64_t nb = (n + BLK - 1) / BLK;
  int64_t ir = 0, in_ = 0, ie = 0;
  int16_t d[BLK];
  for (int64_t b = 0; b < nb; ++b) {
    if (cls[b] == 0) continue;
    int64_t lo = b * BLK, hi = lo + BLK < n ? lo + BLK : n;
    int64_t m = hi - lo;
    for (int64_t i = 0; i < m; ++i)
      d[i] = (int16_t)((int)x[lo + i] - (int)ref[lo + i]);
    for (int64_t i = m; i < BLK; ++i) d[i] = 0;
    if (cls[b] == 2) {
      raw_idx[ir] = (int32_t)b;
      int8_t* out = raw_val + ir * BLK;
      for (int64_t i = 0; i < BLK; ++i)
        out[i] = (int8_t)(d[i] < -128 ? -128 : (d[i] > 127 ? 127 : d[i]));
      for (int64_t i = 0; i < m; ++i) {
        if (d[i] > 127 || d[i] < -128) {
          exc_idx[ie] = (int32_t)(lo + i);
          exc_val[ie] = d[i];
          ++ie;
        }
      }
      ++ir;
    } else {
      nib_idx[in_] = (int32_t)b;
      uint8_t* out = nib + in_ * (BLK / 2);
      for (int64_t i = 0; i < BLK; i += 2) {
        int a0 = d[i] < -8 ? -8 : (d[i] > 7 ? 7 : d[i]);
        int a1 = d[i + 1] < -8 ? -8 : (d[i + 1] > 7 ? 7 : d[i + 1]);
        out[i / 2] = (uint8_t)((a0 + 8) | ((a1 + 8) << 4));
      }
      for (int64_t i = 0; i < m; ++i) {
        if (d[i] > 7 || d[i] < -8) {
          exc_idx[ie] = (int32_t)(lo + i);
          exc_val[ie] = d[i];
          ++ie;
        }
      }
      ++in_;
    }
  }
}

// D2H residual decode: rec = x + expand(nib), then exact exception
// overrides (indices address the unpadded [B,H,W] raster). nib rows are
// ceil(w/2) bytes; an odd trailing nibble is padding and is skipped.
void residual_decode(const uint8_t* x, const uint8_t* nib,
                     int64_t bhw_rows, int64_t w,
                     const int32_t* idx, const int16_t* val, int64_t n_exc,
                     uint8_t* out) {
  int64_t wp = (w + 1) / 2;
  for (int64_t r = 0; r < bhw_rows; ++r) {
    const uint8_t* nr = nib + r * wp;
    uint8_t* orow = out + r * w;
    const uint8_t* xrow = x + r * w;
    for (int64_t c = 0; c < w; ++c) {
      int nv = (c & 1) ? (nr[c >> 1] >> 4) : (nr[c >> 1] & 15);
      int v = (int)xrow[c] + (nv - 8);
      orow[c] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  int64_t n = bhw_rows * w;
  for (int64_t e = 0; e < n_exc; ++e) {
    int64_t i = idx[e];
    if (i < 0 || i >= n) continue;
    int v = (int)x[i] + (int)val[e];
    out[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// Duplex receive decode: scatter the gathered int8 residual-delta
// blocks, integrate over the batch axis (res[b] = res[b-1] + rd[b]), and
// emit rec = x + res. One pass instead of NumPy's scatter/cumsum chain.
// prev_res is the carried last residual [hw]; out_res_last the new carry.
void duplex_decode8(const uint8_t* x, int64_t nframes, int64_t hw,
                    const int8_t* rows, const int32_t* bidx, int64_t kb,
                    int64_t nbp, const int16_t* prev_res,
                    uint8_t* out_rec, int16_t* out_res_last,
                    int16_t* rd_scratch /* [nframes*hw] */) {
  int64_t npx = nframes * hw;
  std::memset(rd_scratch, 0, npx * sizeof(int16_t));
  for (int64_t r = 0; r < kb; ++r) {
    int64_t bi = bidx[r];
    if (bi < 0 || bi >= nbp) continue;  // bucket padding
    int64_t s = bi * BLK;
    const int8_t* nr = rows + r * BLK;
    int64_t m = s + BLK <= npx ? BLK : (npx > s ? npx - s : 0);
    for (int64_t i = 0; i < m; ++i) rd_scratch[s + i] = nr[i];
  }
  std::memcpy(out_res_last, prev_res, hw * sizeof(int16_t));
  for (int64_t f = 0; f < nframes; ++f) {
    const int16_t* rd = rd_scratch + f * hw;
    const uint8_t* xf = x + f * hw;
    uint8_t* of = out_rec + f * hw;
    for (int64_t i = 0; i < hw; ++i) {
      int16_t r = (int16_t)(out_res_last[i] + rd[i]);
      out_res_last[i] = r;
      of[i] = (uint8_t)(xf[i] + r);  // exact: x + (rec-x) wraps to rec
    }
  }
}

// Prediction pass 1: per-8x8-tile any-changed mask (tiles zeroed by the
// caller, [b * ceil(h/8) * ceil(w/8)] row-major).
void duplex_predict_tiles(const uint8_t* x, const uint8_t* ref,
                          int64_t b, int64_t h, int64_t w, uint8_t* tiles) {
  int64_t ht = (h + 7) / 8, wt = (w + 7) / 8;
  for (int64_t f = 0; f < b; ++f) {
    for (int64_t r = 0; r < h; ++r) {
      const uint8_t* xr = x + (f * h + r) * w;
      const uint8_t* rr = ref + (f * h + r) * w;
      uint8_t* trow = tiles + (f * ht + r / 8) * wt;
      for (int64_t c = 0; c < w; ++c)
        if (xr[c] != rr[c]) trow[c / 8] = 1;
    }
  }
}

// Prediction pass 2: mark the flat 256-px blocks intersecting any marked
// (already-dilated) tile. blk is [ceil(b*h*w/256)], zeroed by the caller.
void duplex_predict_blocks(const uint8_t* tiles, int64_t b, int64_t h,
                           int64_t w, uint8_t* blk) {
  int64_t ht = (h + 7) / 8, wt = (w + 7) / 8;
  for (int64_t f = 0; f < b; ++f) {
    for (int64_t tr = 0; tr < ht; ++tr) {
      const uint8_t* trow = tiles + (f * ht + tr) * wt;
      int64_t r1 = (tr * 8 + 8 < h) ? tr * 8 + 8 : h;
      for (int64_t tc = 0; tc < wt; ++tc) {
        if (!trow[tc]) continue;
        int64_t c0 = tc * 8;
        int64_t c1 = (c0 + 8 < w) ? c0 + 8 : w;  // exclusive
        for (int64_t r = tr * 8; r < r1; ++r) {
          int64_t base = (f * h + r) * w;
          int64_t b0 = (base + c0) / BLK, b1 = (base + c1 - 1) / BLK;
          for (int64_t bi = b0; bi <= b1; ++bi) blk[bi] = 1;
        }
      }
    }
  }
}

}  // extern "C"
