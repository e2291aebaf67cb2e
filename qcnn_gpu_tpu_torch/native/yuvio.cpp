// Bulk Y-plane IO of YUV 4:2:0 8-bit files, built at first use by
// qcnn_gpu_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC).
//
// The port's copy of the reader and writer of qcnn_gpu_tpu/native/yuvio.cpp
// (read_y_planes :23, write_y_as_420 :46); the writer also fails when
// fclose's final flush does (a full disk). That file's PSNR,
// preprocess and residual helpers are not copied: the port computes those
// in torch. The NumPy functions in qcnn_gpu_tpu_torch/data/yuv.py
// (read_y_numpy, write_y_as_420_numpy) define the semantics the tests
// hold these to.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Read `frames` Y planes of a YUV420p 8-bit file into out[frames*h*w],
// starting at frame `start`. Returns number of frames read, or -1 on open
// failure. Seeks past UV planes after each Y plane.
long long read_y_planes(const char* path, long long height, long long width,
                        long long start, long long frames, uint8_t* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  const long long ysz = height * width;
  const long long fsz = ysz * 3 / 2;
  if (start > 0) {
    if (fseeko(fp, start * fsz, SEEK_SET) != 0) {
      fclose(fp);
      return -1;
    }
  }
  long long n = 0;
  for (; n < frames; ++n) {
    size_t got = fread(out + n * ysz, 1, (size_t)ysz, fp);
    if ((long long)got < ysz) break;
    if (fseeko(fp, ysz / 2, SEEK_CUR) != 0) break;
  }
  fclose(fp);
  return n;
}

// Write Y planes, each followed by a zero UV plane. Returns 0 ok, -1 on
// an open or write failure.
int write_y_as_420(const char* path, const uint8_t* y, long long frames,
                   long long height, long long width) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  const long long ysz = height * width;
  const long long uvsz = ysz / 2;
  uint8_t* uv = new uint8_t[uvsz];
  memset(uv, 0, (size_t)uvsz);
  int rc = 0;
  for (long long i = 0; i < frames; ++i) {
    if (fwrite(y + i * ysz, 1, (size_t)ysz, fp) != (size_t)ysz ||
        fwrite(uv, 1, (size_t)uvsz, fp) != (size_t)uvsz) {
      rc = -1;
      break;
    }
  }
  delete[] uv;
  if (fclose(fp) != 0) rc = -1;
  return rc;
}

}  // extern "C"
