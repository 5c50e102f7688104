/* Fast JPEG decode + resize for the host input pipeline.
 *
 * The reference decodes every frame with cv2/PIL at full resolution and
 * resizes afterwards (reference: nba_proj/loader.py:4-8,
 * nba_proj/db_maintainence/build_embeddings_store.py:89-96) — at
 * 1920x1080 that wastes ~8x the IDCT work when the target is 224x224.
 * This decoder uses libjpeg(-turbo)'s scaled decode (scale_denom in
 * {1,2,4,8}) to decompress directly at the smallest DCT scale that still
 * covers the target, then bilinearly resizes to the exact target in C.
 * Called from Python via ctypes (GIL released during the call, so host
 * threads genuinely overlap).
 *
 * Build: cc -O3 -shared -fPIC jpeg_fast.c -ljpeg -o _jpeg_fast.so
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stddef.h>
#include <setjmp.h>
#include <jpeglib.h>  /* requires stdio/stddef first for size_t/FILE */

struct err_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf jmp;
};

static void err_exit(j_common_ptr cinfo) {
  struct err_mgr *err = (struct err_mgr *)cinfo->err;
  longjmp(err->jmp, 1);
}

/* Bilinear resize RGB8 (sh, sw) -> (th, tw). */
static void resize_bilinear(const unsigned char *src, int sh, int sw,
                            unsigned char *dst, int th, int tw) {
  if (sh == th && sw == tw) {
    memcpy(dst, src, (size_t)th * tw * 3);
    return;
  }
  const float ys = (float)sh / th;
  const float xs = (float)sw / tw;
  for (int y = 0; y < th; y++) {
    float fy = (y + 0.5f) * ys - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    const unsigned char *r0 = src + (size_t)y0 * sw * 3;
    const unsigned char *r1 = src + (size_t)y1 * sw * 3;
    unsigned char *out = dst + (size_t)y * tw * 3;
    for (int x = 0; x < tw; x++) {
      float fx = (x + 0.5f) * xs - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; c++) {
        float a = r0[x0 * 3 + c] * (1 - wx) + r0[x1 * 3 + c] * wx;
        float b = r1[x0 * 3 + c] * (1 - wx) + r1[x1 * 3 + c] * wx;
        float v = a * (1 - wy) + b * wy;
        out[x * 3 + c] = (unsigned char)(v + 0.5f);
      }
    }
  }
}

/* Decode `data` and write exactly (target_h, target_w, 3) RGB into `out`.
 * Returns 0 on success, nonzero on decode error. */
int decode_resize(const unsigned char *data, long len, int target_h,
                  int target_w, unsigned char *out) {
  struct jpeg_decompress_struct cinfo;
  struct err_mgr jerr;
  /* volatile: modified between setjmp and longjmp; without it the
   * error path may free() a stale register copy (UB, C11 7.13.2.1). */
  unsigned char *volatile tmp = NULL;

  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    free((unsigned char *)tmp);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  /* Largest DCT downscale (1/1, 1/2, 1/4, 1/8) still covering target. */
  int denom = 1;
  while (denom < 8 &&
         (int)cinfo.image_width / (denom * 2) >= target_w &&
         (int)cinfo.image_height / (denom * 2) >= target_h) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;

  jpeg_start_decompress(&cinfo);
  int sw = (int)cinfo.output_width;
  int sh = (int)cinfo.output_height;
  tmp = (unsigned char *)malloc((size_t)sw * sh * 3);
  if (!tmp) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char *row = tmp + (size_t)cinfo.output_scanline * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  resize_bilinear((const unsigned char *)tmp, sh, sw, out, target_h,
                  target_w);
  free((unsigned char *)tmp);
  return 0;
}

/* Batched file decode: paths as a NUL-separated buffer. Writes
 * (n, target_h, target_w, 3) into `out`; status[i] nonzero on failure. */
int decode_files(const char *paths, int n, int target_h, int target_w,
                 unsigned char *out, int *status) {
  const char *p = paths;
  size_t frame = (size_t)target_h * target_w * 3;
  for (int i = 0; i < n; i++) {
    FILE *f = fopen(p, "rb");
    if (!f) {
      status[i] = 3;
    } else {
      fseek(f, 0, SEEK_END);
      long len = ftell(f);
      fseek(f, 0, SEEK_SET);
      unsigned char *buf = (unsigned char *)malloc((size_t)len);
      if (buf && fread(buf, 1, (size_t)len, f) == (size_t)len) {
        status[i] = decode_resize(buf, len, target_h, target_w,
                                  out + frame * i);
      } else {
        status[i] = 4;
      }
      free(buf);
      fclose(f);
    }
    p += strlen(p) + 1;
  }
  return 0;
}
