/* Writes a JPEG with libjpeg's compressor, for the fixtures that cv2 and PIL
 * cannot write: arithmetic coding (sequential and progressive, with restart
 * intervals and DAC conditioning), CMYK and YCCK with or without the Adobe
 * marker, 2-component files, and progressive scan scripts that leave
 * coefficient bits unsent. Built by make_fixtures.py with the system's cc
 * against its jpeglib.h:
 *
 *   cc -O2 -o write_jpeg write_jpeg.c -ljpeg
 *   write_jpeg IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS IN_SPACE [key=value ...]
 *
 * IN.raw holds HEIGHT rows of WIDTH pixels of COMPONENTS interleaved bytes;
 * IN_SPACE is gray, rgb, cmyk or unknown. Keys: quality, arith, progressive
 * (jpeg_simple_progression), optimize, restart (MCUs), colorspace (gray,
 * ycbcr, rgb, cmyk, ycck, unknown), adobe and jfif (write the marker or not),
 * sampling (HxV per component, comma-separated), dc_l, dc_u, ac_k (the
 * arithmetic conditioning of every table, written in the DAC marker), and
 * scans: a scan script, scans separated by ';', each
 * "c0,c1,...:Ss:Se:Ah:Al".
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static J_COLOR_SPACE space(const char *s) {
  if (!strcmp(s, "gray")) return JCS_GRAYSCALE;
  if (!strcmp(s, "rgb")) return JCS_RGB;
  if (!strcmp(s, "ycbcr")) return JCS_YCbCr;
  if (!strcmp(s, "cmyk")) return JCS_CMYK;
  if (!strcmp(s, "ycck")) return JCS_YCCK;
  if (!strcmp(s, "unknown")) return JCS_UNKNOWN;
  fprintf(stderr, "unknown colour space %s\n", s);
  exit(2);
}

static jpeg_scan_info scans[64];

static int parse_scans(char *s) {
  int n = 0;
  char *outer, *inner;
  for (char *tok = strtok_r(s, ";", &outer); tok; tok = strtok_r(NULL, ";", &outer)) {
    jpeg_scan_info *si = &scans[n++];
    char comps[32];
    if (sscanf(tok, "%31[0-9,]:%d:%d:%d:%d", comps, &si->Ss, &si->Se, &si->Ah, &si->Al) != 5) {
      fprintf(stderr, "bad scan %s\n", tok);
      exit(2);
    }
    si->comps_in_scan = 0;
    for (char *c = strtok_r(comps, ",", &inner); c; c = strtok_r(NULL, ",", &inner))
      si->component_index[si->comps_in_scan++] = atoi(c);
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 7) {
    fprintf(stderr, "usage: write_jpeg IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS IN_SPACE [key=value ...]\n");
    return 2;
  }
  const int width = atoi(argv[3]), height = atoi(argv[4]), comps = atoi(argv[5]);
  FILE *in = fopen(argv[1], "rb");
  if (!in) return 1;
  unsigned char *pixels = malloc((size_t)width * height * comps);
  if (fread(pixels, 1, (size_t)width * height * comps, in) != (size_t)width * height * comps) return 1;
  fclose(in);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 1;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = comps;
  cinfo.in_color_space = space(argv[6]);
  jpeg_set_defaults(&cinfo);

  int quality = 90, progressive = 0, adobe = -1, jfif = -1, n_scans = 0;
  char *sampling = NULL;
  for (int i = 7; i < argc; i++) {
    char *eq = strchr(argv[i], '=');
    if (!eq) return 2;
    *eq = 0;
    const char *k = argv[i], *v = eq + 1;
    if (!strcmp(k, "quality")) quality = atoi(v);
    else if (!strcmp(k, "arith")) cinfo.arith_code = atoi(v);
    else if (!strcmp(k, "progressive")) progressive = atoi(v);
    else if (!strcmp(k, "optimize")) cinfo.optimize_coding = atoi(v);
    else if (!strcmp(k, "restart")) cinfo.restart_interval = atoi(v);
    else if (!strcmp(k, "colorspace")) jpeg_set_colorspace(&cinfo, space(v));
    else if (!strcmp(k, "adobe")) adobe = atoi(v);
    else if (!strcmp(k, "jfif")) jfif = atoi(v);
    else if (!strcmp(k, "sampling")) sampling = strdup(v);
    else if (!strcmp(k, "scans")) n_scans = parse_scans(strdup(v));
    else if (!strcmp(k, "dc_l") || !strcmp(k, "dc_u") || !strcmp(k, "ac_k")) {
      for (int t = 0; t < NUM_ARITH_TBLS; t++) {
        if (k[3] == 'l') cinfo.arith_dc_L[t] = atoi(v);
        else if (k[3] == 'u') cinfo.arith_dc_U[t] = atoi(v);
        else cinfo.arith_ac_K[t] = atoi(v);
      }
    } else {
      fprintf(stderr, "unknown key %s\n", k);
      return 2;
    }
  }
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (adobe >= 0) cinfo.write_Adobe_marker = adobe;
  if (jfif >= 0) cinfo.write_JFIF_header = jfif;
  if (sampling) {
    int ci = 0;
    for (char *tok = strtok(sampling, ","); tok && ci < cinfo.num_components; tok = strtok(NULL, ","), ci++)
      if (sscanf(tok, "%dx%d", &cinfo.comp_info[ci].h_samp_factor, &cinfo.comp_info[ci].v_samp_factor) != 2)
        return 2;
  }
  if (progressive) jpeg_simple_progression(&cinfo);
  if (n_scans) {
    cinfo.scan_info = scans;
    cinfo.num_scans = n_scans;
  }

  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + (size_t)cinfo.next_scanline * width * comps;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
