// WebP decoding, as libwebp 1.6's WebPAnimDecoder gives the first frame
// (which is how PIL opens every WebP file), behind a plain C interface bound
// with ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the RIFF container: simple `VP8 ` and `VP8L` files, and extended `VP8X`
//     files with `ALPH`, `ICCP`, `EXIF` and `XMP ` (skipped) chunks; of an
//     animation (`ANIM` / `ANMF`) the first frame, placed at its offset on a
//     canvas cleared to transparent black;
//   * VP8L lossless (RFC 9649): the predictor (14 modes), cross-colour,
//     subtract-green and colour-indexing transforms with pixel bundling, the
//     meta prefix-code image, the colour cache and LZ77 with the 120-code
//     distance map;
//   * VP8 lossy (RFC 6386) as libwebp decodes it: its boolean decoder (the
//     signed-coefficient read included), segments, the token partitions, the
//     16x16 / 4x4 / chroma intra predictors with libwebp's 127 / 129 borders,
//     the inverse WHT and DCT, the simple and normal loop filters; then
//     libwebp's fancy upsampler (dsp/upsampling.c) and its fixed-point
//     VP8YUVToR/G/B (dsp/yuv.h);
//   * ALPH: raw or VP8L-coded alpha planes under the none, horizontal,
//     vertical and gradient filters.
//
// The result is (H, W, 4) RGBA, not premultiplied. Corrupt or truncated data
// returns RF_CORRUPT with a message; every read is bounded by the buffer.
// The probability and quantizer tables are RFC 6386's; kCodeToPlane is RFC
// 9649's distance map.

#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (static_cast<uint32_t>(p[3]) << 24); }

// RFC 6386 13.4 / 13.5 (default_coeff_probs, coeff_update_probs), 11.5 (the
// sub-block mode probabilities in libwebp's mode order), 14.1 (dc_qlookup,
// ac_qlookup); RFC 9649 4.2.2 (the distance map, as (y << 4) | (8 - x)).
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------- VP8L ----

// LSB-first bits; reads past the end give zeros and mark the stream overrun.
class LBits {
 public:
  LBits(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  uint64_t window() const {
    size_t p = pos_ >> 3;
    uint64_t w = 0;
    if (p + 8 <= n_) {
      memcpy(&w, d_ + p, 8);
    } else {
      for (size_t i = 0; i < 8 && p + i < n_; ++i) w |= static_cast<uint64_t>(d_[p + i]) << (8 * i);
    }
    return w >> (pos_ & 7);
  }
  uint32_t read(int nbits) {
    if (nbits == 0) return 0;
    uint32_t v = static_cast<uint32_t>(window() & ((uint64_t(1) << nbits) - 1));
    pos_ += nbits;
    return v;
  }
  void skip(int nbits) { pos_ += nbits; }
  bool eos() const { return pos_ > 8 * n_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
};

constexpr int kMaxCodeLen = 15;
constexpr int kLookBits = 8;

// A canonical prefix code, read MSB of the code first (libwebp's tables).
struct PrefixCode {
  int single = -1;  // the one symbol of a 0-bit code
  uint16_t look[1 << kLookBits];  // (length << 12) | symbol, 0 for longer codes
  uint16_t count[kMaxCodeLen + 1];
  std::vector<uint16_t> sorted;

  // huffman_utils.c BuildHuffmanTable: false for an empty or incomplete code.
  bool build(const uint8_t* lengths, int n) {
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) ++count[lengths[s]];
    if (count[0] == n) return false;
    sorted.clear();
    for (int l = 1; l <= kMaxCodeLen; ++l)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == l) sorted.push_back(static_cast<uint16_t>(s));
    memset(look, 0, sizeof(look));
    if (sorted.size() == 1) {
      single = sorted[0];
      return true;
    }
    single = -1;
    int64_t left = 1;
    for (int l = 1; l <= kMaxCodeLen; ++l) {
      left = 2 * left - count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    uint32_t code = 0;
    size_t i = 0;
    for (int l = 1; l <= kMaxCodeLen; ++l) {
      for (int k = 0; k < count[l]; ++k, ++i, ++code) {
        if (l > kLookBits) continue;
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (uint32_t r = rev; r < (1u << kLookBits); r += 1u << l)
          look[r] = static_cast<uint16_t>((l << 12) | sorted[i]);
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBits& br) const {
    if (single >= 0) return single;
    uint64_t w = br.window();
    uint16_t e = look[w & ((1 << kLookBits) - 1)];
    if (e) {
      br.skip(e >> 12);
      return e & 0xFFF;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= kMaxCodeLen; ++l) {
      code |= static_cast<int>((w >> (l - 1)) & 1);
      int c = count[l];
      if (code - first < c) {
        br.skip(l);
        return sorted[index + code - first];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return sorted.back();  // unreachable for a complete code
  }
};

const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xFF00FF00u) + (b & 0xFF00FF00u);
  uint32_t rb = (a & 0x00FF00FFu) + (b & 0x00FF00FFu);
  return (ag & 0xFF00FF00u) | (rb & 0x00FF00FFu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int sub3(int a, int b, int c) {
  int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // lossless_common.h Select
  int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xFF, (b >> 16) & 0xFF, (c >> 16) & 0xFF) +
          sub3((a >> 8) & 0xFF, (b >> 8) & 0xFF, (c >> 8) & 0xFF) + sub3(a & 0xFF, b & 0xFF, c & 0xFF);
  return d <= 0 ? a : b;
}
inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 0xFF) + static_cast<int>((b >> s) & 0xFF) -
                                         static_cast<int>((c >> s) & 0xFF))) << s;
  return out;
}
inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = static_cast<int>((a >> s) & 0xFF), y = static_cast<int>((b >> s) & 0xFF);
    out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xFF000000u;  // 0, and 14 / 15 as libwebp reads them
  }
}

class VP8L {
 public:
  VP8L(const uint8_t* d, size_t n) : br_(d, n) {}

  // The main image of a VP8L chunk (header included): ARGB, (h, w).
  std::vector<uint32_t> decode_chunk(int& w, int& h) {
    if (br_.read(8) != 0x2F) corrupt("bad VP8L signature");
    w = static_cast<int>(br_.read(14)) + 1;
    h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);
    if (br_.read(3) != 0) corrupt("bad VP8L version");
    return stream(w, h, true);
  }

  // The headerless stream of an ALPH chunk.
  std::vector<uint32_t> decode_headerless(int w, int h) { return stream(w, h, true); }

 private:
  struct Transform {
    int type, bits, xsize;
    std::vector<uint32_t> data;
  };
  LBits br_;
  unsigned seen_ = 0;
  std::vector<Transform> transforms_;

  void check() {
    if (br_.eos()) corrupt("truncated VP8L data");
  }

  void read_code(int alphabet, PrefixCode& code) {
    uint8_t lengths[256 + 24 + 2048];
    memset(lengths, 0, sizeof(lengths));
    if (br_.read(1)) {  // simple code: one or two symbols of length 1
      int nsym = static_cast<int>(br_.read(1)) + 1;
      int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (nsym == 2) lengths[br_.read(8)] = 1;
    } else {
      uint8_t cl_lengths[19] = {0};
      int ncodes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < ncodes; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<uint8_t>(br_.read(3));
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) corrupt("bad VP8L code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) corrupt("bad VP8L code lengths");
      }
      int prev = 8, sym = 0;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        int c = cl.decode(br_);
        if (c < 16) {
          lengths[sym++] = static_cast<uint8_t>(c);
          if (c) prev = c;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = static_cast<int>(br_.read(kExtra[c - 16])) + kOffset[c - 16];
          if (sym + repeat > alphabet) corrupt("bad VP8L code lengths");
          int len = c == 16 ? prev : 0;
          while (repeat-- > 0) lengths[sym++] = static_cast<uint8_t>(len);
        }
        check();
      }
    }
    check();
    if (!code.build(lengths, alphabet)) corrupt("bad VP8L prefix code");
  }

  void read_transform(int& xsize, int ysize) {
    int type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << type)) corrupt("repeated VP8L transform");
    seen_ |= 1u << type;
    Transform t{type, 0, xsize, {}};
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      int ncolors = static_cast<int>(br_.read(8)) + 1;
      t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      std::vector<uint32_t> pal = stream(ncolors, 1, false);
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);  // past the palette: transparent black
      t.data[0] = pal[0];
      for (int i = 1; i < ncolors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
      xsize = subsample(xsize, t.bits);
    }
    transforms_.push_back(std::move(t));
  }

  std::vector<uint32_t> stream(int xsize, int ysize, bool level0) {
    int txsize = xsize;
    size_t first_transform = transforms_.size();
    if (level0)
      while (br_.read(1)) {
        check();
        read_transform(txsize, ysize);
      }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) corrupt("bad VP8L colour cache size");
    }
    int hbits = 0, hxsize = 0, ngroups = 1;
    std::vector<uint32_t> himage;
    if (level0 && br_.read(1)) {
      hbits = static_cast<int>(br_.read(3)) + 2;
      hxsize = subsample(txsize, hbits);
      himage = stream(hxsize, subsample(ysize, hbits), false);
      for (auto& p : himage) {
        p = (p >> 8) & 0xFFFF;
        if (static_cast<int>(p) + 1 > ngroups) ngroups = static_cast<int>(p) + 1;
      }
    }
    check();
    std::vector<int> used(static_cast<size_t>(ngroups), himage.empty() ? 0 : -1);
    int nused = himage.empty() ? 1 : 0;
    for (uint32_t p : himage)
      if (used[p] < 0) used[p] = nused++;
    std::vector<PrefixCode> codes(static_cast<size_t>(nused) * 5);
    PrefixCode scratch;
    for (int g = 0; g < ngroups; ++g)
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(alphabet, used[g] < 0 ? scratch : codes[static_cast<size_t>(used[g]) * 5 + j]);
      }
    std::vector<uint32_t> px = pixels(txsize, ysize, codes, used, himage, hbits, hxsize, cache_bits);
    if (level0)
      for (size_t i = transforms_.size(); i-- > first_transform;) px = inverse(transforms_[i], px, ysize);
    return px;
  }

  std::vector<uint32_t> pixels(int w, int h, const std::vector<PrefixCode>& codes, const std::vector<int>& used,
                               const std::vector<uint32_t>& himage, int hbits, int hxsize, int cache_bits) {
    const size_t total = static_cast<size_t>(w) * h;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? static_cast<size_t>(1) << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1E35A7BDu * argb) >> cache_shift] = argb;
    };
    size_t pos = 0;
    int x = 0, y = 0;
    const int mask = himage.empty() ? -1 : (1 << hbits) - 1;
    const PrefixCode* g = codes.data();
    auto group = [&]() {
      if (!himage.empty()) g = codes.data() + static_cast<size_t>(used[himage[static_cast<size_t>(y >> hbits) * hxsize + (x >> hbits)]]) * 5;
    };
    group();
    while (pos < total) {
      if ((x & mask) == 0) group();
      int code = g[0].decode(br_);
      if (code < 256) {
        int r = g[1].decode(br_), b = g[2].decode(br_), a = g[3].decode(br_);
        uint32_t argb = (static_cast<uint32_t>(a) << 24) | (r << 16) | (code << 8) | b;
        px[pos++] = argb;
        insert(argb);
        if (++x >= w) {
          x = 0;
          ++y;
        }
      } else if (code < 256 + 24) {
        auto prefix_value = [&](int sym) -> int {
          if (sym < 4) return sym + 1;
          int extra = (sym - 2) >> 1;
          int offset = (2 + (sym & 1)) << extra;
          return offset + static_cast<int>(br_.read(extra)) + 1;
        };
        int length = prefix_value(code - 256);
        int dsym = g[4].decode(br_);
        int dcode = prefix_value(dsym);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int dc = kCodeToPlane[dcode - 1];
          dist = static_cast<int64_t>(dc >> 4) * w + (8 - (dc & 15));
          if (dist < 1) dist = 1;
        }
        check();
        if (static_cast<int64_t>(pos) < dist || static_cast<int64_t>(total - pos) < length)
          corrupt("bad VP8L backward reference");
        for (int i = 0; i < length; ++i, ++pos) {
          px[pos] = px[pos - dist];
          insert(px[pos]);
        }
        x += length;
        while (x >= w) {
          x -= w;
          ++y;
        }
        if (pos < total) group();
      } else {
        int key = code - 256 - 24;
        if (key >= static_cast<int>(cache.size())) corrupt("bad VP8L colour cache code");
        uint32_t argb = cache[key];
        px[pos++] = argb;
        insert(argb);
        if (++x >= w) {
          x = 0;
          ++y;
        }
      }
      check();
    }
    return px;
  }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in, int h) {
    const int w = t.xsize;
    if (t.type == 2) {  // subtract green
      for (uint32_t& p : in) {
        uint32_t green = (p >> 8) & 0xFF;
        uint32_t rb = (p & 0x00FF00FFu) + ((green << 16) | green);
        p = (p & 0xFF00FF00u) | (rb & 0x00FF00FFu);
      }
      return std::move(in);
    }
    if (t.type == 3) {  // colour indexing, with pixel bundling
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int pw = subsample(w, t.bits), bpp = 8 >> t.bits, ppb = 1 << t.bits;
      const uint32_t m = (1u << bpp) - 1;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t g = (in[static_cast<size_t>(y) * pw + (x >> t.bits)] >> 8) & 0xFF;
          uint32_t idx = (g >> ((x & (ppb - 1)) * bpp)) & m;
          out[static_cast<size_t>(y) * w + x] = t.data[idx];
        }
      return out;
    }
    const int tw = subsample(w, t.bits);
    if (t.type == 1) {  // cross colour
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t code = t.data[static_cast<size_t>(y >> t.bits) * tw + (x >> t.bits)];
          int8_t g2r = static_cast<int8_t>(code & 0xFF), g2b = static_cast<int8_t>((code >> 8) & 0xFF),
                 r2b = static_cast<int8_t>((code >> 16) & 0xFF);
          uint32_t& p = in[static_cast<size_t>(y) * w + x];
          int8_t green = static_cast<int8_t>(p >> 8);
          int r = static_cast<int>((p >> 16) & 0xFF), b = static_cast<int>(p & 0xFF);
          r = (r + ((g2r * green) >> 5)) & 0xFF;
          b += (g2b * green) >> 5;
          b += (r2b * static_cast<int8_t>(r)) >> 5;
          b &= 0xFF;
          p = (p & 0xFF00FF00u) | (static_cast<uint32_t>(r) << 16) | static_cast<uint32_t>(b);
        }
      return std::move(in);
    }
    // predictor
    uint32_t* px = in.data();
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        size_t i = static_cast<size_t>(y) * w + x;
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xFF000000u : px[i - 1];
        } else if (x == 0) {
          pred = px[i - w];
        } else {
          int mode = (t.data[static_cast<size_t>(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15;
          pred = predict(mode, px[i - 1], px[i - w], px[i - w + 1], px[i - w - 1]);
        }
        px[i] = add_pixels(px[i], pred);
      }
    return std::move(in);
  }
};

// ---------------------------------------------------------------- ALPH ----

// An ALPH chunk's payload -> the (h, w) alpha plane.
std::vector<uint8_t> decode_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n < 1) corrupt("empty ALPH chunk");
  int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3, rsrv = d[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) corrupt("bad ALPH header");
  const size_t total = static_cast<size_t>(w) * h;
  std::vector<uint8_t> a(total);
  if (method == 0) {
    if (n - 1 < total) corrupt("truncated ALPH data");
    memcpy(a.data(), d + 1, total);
  } else {
    VP8L dec(d + 1, n - 1);
    std::vector<uint32_t> argb = dec.decode_headerless(w, h);
    for (size_t i = 0; i < total; ++i) a[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
  if (filter == 0) return a;
  for (int y = 0; y < h; ++y) {  // filters.c HorizontalUnfilter / VerticalUnfilter / GradientUnfilter
    uint8_t* row = a.data() + static_cast<size_t>(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (!prev || filter == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        int top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xFF) == 0 ? g : (g < 0 ? 0 : 255);
        left = static_cast<uint8_t>(row[x] + g);
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return a;
}

// ----------------------------------------------------------------- VP8 ----

// libwebp's boolean decoder (utils/bit_reader*), byte-wise loading.
class BoolReader {
 public:
  void init(const uint8_t* d, size_t n) {
    buf_ = d;
    end_ = d + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  int signed_value(int v) {  // VP8GetSigned
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int32_t mask = static_cast<int32_t>(split - value) >> 31;
    bits_ -= 1;
    range_ += static_cast<uint32_t>(mask);
    range_ |= 1;
    value_ -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_bits(int nbits) {
    int v = value(nbits);
    return value(1) ? -v : v;
  }

 private:
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = -8;
  uint32_t range_ = 254;
  bool eof_ = false;

  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };

const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

// dsp/dec.c TransformOne, added to the prediction in dst.
void transform(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, static_cast<size_t>(size));
}

// 16x16 (size 16) and chroma (size 8) predictors, DC variants at the edges.
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, size, (dc + size) >> (shift + 1));
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, (dc + size / 2) >> shift);
      break;
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, static_cast<size_t>(size));
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], static_cast<size_t>(size));
      break;
    default:
      corrupt("bad VP8 intra mode");
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, static_cast<int>(dc >> 3));
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:
      corrupt("bad VP8 intra mode");
  }
}
#undef DST

// dsp/dec.c loop filters.
inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }
inline int iabs(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  return iabs(p[-2 * step] - p[-step]) > thresh || iabs(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * iabs(p[-step] - p[0]) + iabs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it && iabs(q3 - q2) <= it &&
         iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int step, int along, int thresh) {  // 16 pixels
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, t2)) do_filter2(p + i * along, step);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride)
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t))
        do_filter2(p, hstride);
      else if (edge)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
}

struct MBInfo {
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16];
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

class VP8 {
 public:
  // A VP8 chunk's payload -> RGBA (h, w) into `out` with row stride `stride`
  // bytes; the alpha bytes are left as they are.
  void header(const uint8_t* d, size_t n) {
    if (n < 10) corrupt("truncated VP8 header");
    const uint32_t bits = le24(d);
    if (bits & 1) corrupt("VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) corrupt("unknown VP8 profile");
    if (!((bits >> 4) & 1)) corrupt("VP8 frame is not shown");
    part0_ = bits >> 5;
    if (d[3] != 0x9D || d[4] != 0x01 || d[5] != 0x2A) corrupt("bad VP8 start code");
    w_ = (d[6] | (d[7] << 8)) & 0x3FFF;
    h_ = (d[8] | (d[9] << 8)) & 0x3FFF;
    if (w_ == 0 || h_ == 0) corrupt("VP8 frame of size 0");
    if (part0_ >= n) corrupt("bad VP8 partition length");
    d_ = d;
    n_ = n;
  }
  int width() const { return w_; }
  int height() const { return h_; }

  void decode(uint8_t* out, size_t stride) {
    parse_headers();
    mb_w_ = (w_ + 15) >> 4;
    mb_h_ = (h_ + 15) >> 4;
    ys_ = mb_w_ * 16;
    uvs_ = mb_w_ * 8;
    y_.assign(static_cast<size_t>(ys_) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uvs_) * mb_h_ * 8, 0);
    v_.assign(u_.size(), 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FInfo{});
    std::vector<uint8_t> intra_t(static_cast<size_t>(4) * mb_w_, B_DC);
    std::vector<uint8_t> nz(static_cast<size_t>(mb_w_), 0), nz_dc(static_cast<size_t>(mb_w_), 0);
    std::vector<MBInfo> row(static_cast<size_t>(mb_w_));
    int16_t coeffs[384];
    for (int mby = 0; mby < mb_h_; ++mby) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mbx = 0; mbx < mb_w_; ++mbx) parse_modes(row[mbx], intra_t.data() + 4 * mbx, intra_l);
      if (br_.eof()) corrupt("premature end of VP8 partition 0");
      BoolReader& tbr = parts_[mby & (nparts_ - 1)];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mbx = 0; mbx < mb_w_; ++mbx) {
        const MBInfo& mb = row[mbx];
        bool skip = use_skip_ && mb.skip;
        memset(coeffs, 0, sizeof(coeffs));
        if (!skip) {
          skip = !residuals(tbr, mb, nz[mbx], nz_dc[mbx], left_nz, left_nz_dc, coeffs);
        } else {
          left_nz = nz[mbx] = 0;
          if (!mb.is_i4x4) left_nz_dc = nz_dc[mbx] = 0;
        }
        if (tbr.eof()) corrupt("premature end of VP8 data");
        if (filter_type_ > 0) {
          FInfo f = fstrengths_[mb.segment][mb.is_i4x4];
          f.inner |= !skip;
          finfo_[static_cast<size_t>(mby) * mb_w_ + mbx] = f;
        }
        reconstruct(mbx, mby, mb, coeffs);
      }
    }
    if (filter_type_ > 0)
      for (int mby = 0; mby < mb_h_; ++mby)
        for (int mbx = 0; mbx < mb_w_; ++mbx) loop_filter(mbx, mby);
    to_rgb(out, stride);
  }

 private:
  const uint8_t* d_ = nullptr;
  size_t n_ = 0;
  uint32_t part0_ = 0;
  int w_ = 0, h_ = 0, mb_w_ = 0, mb_h_ = 0, ys_ = 0, uvs_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int nparts_ = 1;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  uint8_t seg_probs_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, filter_type_ = 0;
  bool use_lf_delta_ = false;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int y1_[4][2], y2_[4][2], uv_[4][2];
  uint8_t probas_[4][8][3][11];
  bool use_skip_ = false;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  std::vector<uint8_t> y_, u_, v_;
  std::vector<FInfo> finfo_;

  void parse_headers() {
    const uint8_t* p = d_ + 10;
    size_t rem = n_ - 10;
    if (part0_ > rem) corrupt("bad VP8 partition length");
    br_.init(p, part0_);
    p += part0_;
    rem -= part0_;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {
        absolute_delta_ = br_.value(1);
        for (int& q : quantizer_) q = br_.value(1) ? br_.signed_bits(7) : 0;
        for (int& f : filter_strength_) f = br_.value(1) ? br_.signed_bits(6) : 0;
      }
      if (update_map_)
        for (uint8_t& s : seg_probs_) s = static_cast<uint8_t>(br_.value(1) ? br_.value(8) : 255);
    }
    if (br_.eof()) corrupt("cannot parse the VP8 segment header");
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int& r : ref_lf_delta_)
        if (br_.value(1)) r = br_.signed_bits(6);
      for (int& m : mode_lf_delta_)
        if (br_.value(1)) m = br_.signed_bits(6);
    }
    filter_type_ = level_ == 0 ? 0 : (simple_ ? 1 : 2);
    if (br_.eof()) corrupt("cannot parse the VP8 filter header");
    // token partitions
    const int last = (1 << br_.value(2)) - 1;
    nparts_ = last + 1;
    if (rem < static_cast<size_t>(3 * last)) corrupt("cannot parse the VP8 partitions");
    const uint8_t* sz = p;
    const uint8_t* start = p + 3 * last;
    size_t left = rem - 3 * last;
    for (int i = 0; i < last; ++i, sz += 3) {
      size_t ps = le24(sz);
      if (ps > left) ps = left;
      parts_[i].init(start, ps);
      start += ps;
      left -= ps;
    }
    parts_[last].init(start, left);
    if (left == 0) corrupt("cannot parse the VP8 partitions");
    // quantizers (quant_dec.c VP8ParseQuant)
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.value(1) ? br_.signed_bits(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_bits(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_bits(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_bits(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_bits(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : (v > m ? m : v); };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        memcpy(y1_[i], y1_[0], sizeof(y1_[0]));
        memcpy(y2_[i], y2_[0], sizeof(y2_[0]));
        memcpy(uv_[i], uv_[0], sizeof(uv_[0]));
        continue;
      } else {
        q = base_q0;
      }
      y1_[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_[i][1] = kAcTable[clip(q, 127)];
      y2_[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2_[i][1] < 8) y2_[i][1] = 8;
      uv_[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv_[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br_.value(1);  // update_proba, ignored for a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p2 = 0; p2 < 11; ++p2)
            probas_[t][b][c][p2] = static_cast<uint8_t>(
                br_.bit(kCoeffsUpdateProba[t][b][c][p2]) ? br_.value(8) : kCoeffsProba0[t][b][c][p2]);
    use_skip_ = br_.value(1);
    if (use_skip_) skip_p_ = br_.value(8);
    // frame_dec.c PrecomputeFilterStrengths
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths_[s][i4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : (level > 63 ? 63 : level);
        f = FInfo{};
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * level + ilevel;
          f.hev = level >= 40 ? 2 : (level >= 15 ? 1 : 0);
        }
        f.inner = i4;
      }
    }
  }

  void parse_modes(MBInfo& mb, uint8_t* top, uint8_t* left) {  // tree_dec.c ParseIntraMode
    mb.segment = update_map_ ? static_cast<uint8_t>(!br_.bit(seg_probs_[0]) ? br_.bit(seg_probs_[1])
                                                                            : br_.bit(seg_probs_[2]) + 2)
                             : 0;
    mb.skip = use_skip_ ? static_cast<uint8_t>(br_.bit(skip_p_)) : 0;
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE) : (br_.bit(163) ? B_VE : B_DC);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br_.bit(142) ? B_DC : (!br_.bit(114) ? B_VE : (br_.bit(183) ? B_TM : B_HE));
  }

  // GetCoeffs: the index past the last coefficient read.
  int coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = probas_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = probas_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = probas_[type][kBands[n + 1]];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        if (!br.bit(p[3])) {
          v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
        } else if (!br.bit(p[6])) {
          if (!br.bit(p[7])) {
            v = 5 + br.bit(159);
          } else {
            v = 7 + 2 * br.bit(165);
            v += br.bit(145);
          }
        } else {
          const int bit1 = br.bit(p[8]);
          const int bit0 = br.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = p_ctx[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.signed_value(v) * dq[n > 0]);
    }
    return 16;
  }

  // vp8_dec.c ParseResiduals: false when libwebp finds no coefficient in the
  // macroblock (its non_zero_y | non_zero_uv: a block read past index 1, or
  // with a nonzero DC).
  bool residuals(BoolReader& br, const MBInfo& mb, uint8_t& t_nz, uint8_t& t_nz_dc, uint8_t& l_nz,
                 uint8_t& l_nz_dc, int16_t* dst) {
    const int* y1 = y1_[mb.segment];
    int first, ac_type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = t_nz_dc + l_nz_dc;
      const int nz = coeffs(br, 1, ctx, y2_[mb.segment], 0, dc);
      t_nz_dc = l_nz_dc = nz > 0;
      transform_wht(dc, dst);
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    bool any = false;
    uint32_t tnz = t_nz & 0x0F, lnz = l_nz & 0x0F;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x, dst += 16) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 7);
        any |= nz > 1 || dst[0] != 0;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 7);
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = t_nz >> (4 + ch);
      lnz = l_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x, dst += 16) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, uv_[mb.segment], 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (static_cast<uint32_t>(l) << 3);
          any |= nz > 1 || dst[0] != 0;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (static_cast<uint32_t>(l) << 5);
      }
      out_t |= (tnz << 4) << ch;
      out_l |= (lnz & 0xF0) << ch;
    }
    t_nz = static_cast<uint8_t>(out_t);
    l_nz = static_cast<uint8_t>(out_l);
    return any;
  }

  // frame_dec.c ReconstructRow for one macroblock, from the unfiltered planes.
  void reconstruct(int mbx, int mby, const MBInfo& mb, const int16_t* coeffs) {
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* yd = ybuf + BPS + 8;
    uint8_t* ud = ubuf + BPS + 8;
    uint8_t* vd = vbuf + BPS + 8;
    const int x0 = mbx * 16, y0 = mby * 16, cx0 = mbx * 8, cy0 = mby * 8;
    auto border = [&](uint8_t* dst, const std::vector<uint8_t>& plane, int stride, int px, int py, int size) {
      for (int j = 0; j < size; ++j)
        dst[j * BPS - 1] = mbx > 0 ? plane[static_cast<size_t>(py + j) * stride + px - 1] : 129;
      if (mby > 0) {
        memcpy(dst - BPS, plane.data() + static_cast<size_t>(py - 1) * stride + px, static_cast<size_t>(size));
        dst[-BPS - 1] = mbx > 0 ? plane[static_cast<size_t>(py - 1) * stride + px - 1] : 129;
      } else {
        memset(dst - BPS - 1, 127, static_cast<size_t>(size) + 1 + (size == 16 ? 4 : 0));
      }
    };
    border(yd, y_, ys_, x0, y0, 16);
    border(ud, u_, uvs_, cx0, cy0, 8);
    border(vd, v_, uvs_, cx0, cy0, 8);
    if (mb.is_i4x4) {
      uint8_t* top_right = yd - BPS + 16;
      if (mby > 0) {
        const uint8_t* above = y_.data() + static_cast<size_t>(y0 - 1) * ys_;
        if (mbx >= mb_w_ - 1)
          memset(top_right, above[x0 + 15], 4);
        else
          memcpy(top_right, above + x0 + 16, 4);
      }
      for (int r = 1; r <= 3; ++r) memcpy(top_right + r * 4 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, mb.imodes[n]);
        transform(coeffs + n * 16, dst);
      }
    } else {
      predict_block(yd, 16, edge_mode(mbx, mby, mb.imodes[0]));
      for (int n = 0; n < 16; ++n) transform(coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = edge_mode(mbx, mby, mb.uvmode);
    predict_block(ud, 8, uvmode);
    predict_block(vd, 8, uvmode);
    for (int n = 0; n < 4; ++n) {
      transform(coeffs + 256 + n * 16, ud + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      transform(coeffs + 320 + n * 16, vd + (n & 1) * 4 + (n >> 1) * 4 * BPS);
    }
    for (int j = 0; j < 16; ++j) memcpy(y_.data() + static_cast<size_t>(y0 + j) * ys_ + x0, yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(u_.data() + static_cast<size_t>(cy0 + j) * uvs_ + cx0, ud + j * BPS, 8);
      memcpy(v_.data() + static_cast<size_t>(cy0 + j) * uvs_ + cx0, vd + j * BPS, 8);
    }
  }

  static int edge_mode(int mbx, int mby, int mode) {
    if (mode != B_DC) return mode;
    if (mbx == 0) return mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mby == 0 ? DC_NOTOP : B_DC;
  }

  void loop_filter(int mbx, int mby) {  // frame_dec.c DoFilter
    const FInfo& f = finfo_[static_cast<size_t>(mby) * mb_w_ + mbx];
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* yd = y_.data() + static_cast<size_t>(mby) * 16 * ys_ + mbx * 16;
    const int s = ys_;
    if (filter_type_ == 1) {
      if (mbx > 0) simple_filter(yd, 1, s, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, s, limit);
      if (mby > 0) simple_filter(yd, s, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * s, s, 1, limit);
      return;
    }
    const int us = uvs_;
    uint8_t* ud = u_.data() + static_cast<size_t>(mby) * 8 * us + mbx * 8;
    uint8_t* vd = v_.data() + static_cast<size_t>(mby) * 8 * us + mbx * 8;
    const int il = f.ilevel, ht = f.hev;
    if (mbx > 0) {
      filter_loop(yd, 1, s, 16, limit + 4, il, ht, true);
      filter_loop(ud, 1, us, 8, limit + 4, il, ht, true);
      filter_loop(vd, 1, us, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, s, 16, limit, il, ht, false);
      filter_loop(ud + 4, 1, us, 8, limit, il, ht, false);
      filter_loop(vd + 4, 1, us, 8, limit, il, ht, false);
    }
    if (mby > 0) {
      filter_loop(yd, s, 1, 16, limit + 4, il, ht, true);
      filter_loop(ud, us, 1, 8, limit + 4, il, ht, true);
      filter_loop(vd, us, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k * s, s, 1, 16, limit, il, ht, false);
      filter_loop(ud + 4 * us, us, 1, 8, limit, il, ht, false);
      filter_loop(vd + 4 * us, us, 1, 8, limit, il, ht, false);
    }
  }

  // dsp/yuv.h VP8YUVToR/G/B
  static inline uint8_t yuv_clip(int v) {
    return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : (v < 0 ? 0 : 255));
  }
  static inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    auto hi = [](int a, int c) { return (a * c) >> 8; };
    rgb[0] = yuv_clip(hi(y, 19077) + hi(v, 26149) - 14234);
    rgb[1] = yuv_clip(hi(y, 19077) - hi(u, 6419) - hi(v, 13320) + 8708);
    rgb[2] = yuv_clip(hi(y, 19077) + hi(u, 33050) - 17685);
  }

  // dsp/upsampling.c UPSAMPLE_FUNC over one pair of rows (bottom may be null).
  void upsample(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* top_u, const uint8_t* top_v,
                const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bot_dst) const {
    const int len = w_;
    const int last_pair = (len - 1) >> 1;
    int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
    yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bot_y) yuv_to_rgb(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = top_u[x], t_v = top_v[x], c_u = cur_u[x], c_v = cur_v[x];
      const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
      yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 4);
      yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
      if (bot_y) {
        yuv_to_rgb(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bot_dst + (2 * x - 1) * 4);
        yuv_to_rgb(bot_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, bot_dst + 2 * x * 4);
      }
      tl_u = t_u;
      tl_v = t_v;
      l_u = c_u;
      l_v = c_v;
    }
    if (!(len & 1)) {
      yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 4);
      if (bot_y)
        yuv_to_rgb(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst + (len - 1) * 4);
    }
  }

  // io_dec.c EmitFancyRGB over the whole picture.
  void to_rgb(uint8_t* out, size_t stride) const {
    auto yrow = [&](int y) { return y_.data() + static_cast<size_t>(y) * ys_; };
    auto urow = [&](int y) { return u_.data() + static_cast<size_t>(y) * uvs_; };
    auto vrow = [&](int y) { return v_.data() + static_cast<size_t>(y) * uvs_; };
    upsample(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), out, nullptr);
    int y = 1;
    for (; y + 1 < h_; y += 2) {
      const int c = (y + 1) >> 1;
      upsample(yrow(y), yrow(y + 1), urow(c - 1), vrow(c - 1), urow(c), vrow(c), out + y * stride,
               out + (y + 1) * stride);
    }
    if (y < h_) {  // the last row of an even height
      const int c = (h_ - 1) >> 1;
      upsample(yrow(h_ - 1), nullptr, urow(c), vrow(c), urow(c), vrow(c), out + (h_ - 1) * stride, nullptr);
    }
  }
};

// ------------------------------------------------------------ container ----

struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  size_t size;
};

constexpr uint32_t fourcc(const char* s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(s[0])) | (static_cast<uint32_t>(static_cast<uint8_t>(s[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[3])) << 24);
}

std::vector<Chunk> chunks(const uint8_t* d, size_t n) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 8) corrupt("truncated WebP chunk header");
    const size_t size = le32(d + pos + 4);
    if (size > n - pos - 8) corrupt("truncated WebP chunk");
    out.push_back(Chunk{le32(d + pos), d + pos + 8, size});
    pos += 8 + size + (size & 1);
  }
  return out;
}

// One frame (an image chunk and its ALPH chunk, if any) -> its size, and with
// `out` its RGBA pixels at row stride `stride`.
struct Frame {
  const Chunk* alpha = nullptr;
  const Chunk* image = nullptr;
};

void frame_size(const Frame& f, int& w, int& h) {
  const uint8_t* d = f.image->data;
  const size_t n = f.image->size;
  if (f.image->tag == fourcc("VP8L")) {
    if (n < 5 || d[0] != 0x2F) corrupt("bad VP8L header");
    const uint32_t bits = le32(d + 1);
    w = static_cast<int>(bits & 0x3FFF) + 1;
    h = static_cast<int>((bits >> 14) & 0x3FFF) + 1;
  } else {
    VP8 v;
    v.header(d, n);
    w = v.width();
    h = v.height();
  }
}

void decode_frame(const Frame& f, uint8_t* out, size_t stride) {
  if (f.image->tag == fourcc("VP8L")) {
    VP8L dec(f.image->data, f.image->size);
    int w = 0, h = 0;
    std::vector<uint32_t> argb = dec.decode_chunk(w, h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[static_cast<size_t>(y) * w + x];
        uint8_t* o = out + y * stride + 4 * x;
        o[0] = static_cast<uint8_t>(p >> 16);
        o[1] = static_cast<uint8_t>(p >> 8);
        o[2] = static_cast<uint8_t>(p);
        o[3] = static_cast<uint8_t>(p >> 24);
      }
    return;
  }
  VP8 v;
  v.header(f.image->data, f.image->size);
  const int w = v.width(), h = v.height();
  std::vector<uint8_t> alpha;
  if (f.alpha) alpha = decode_alpha(f.alpha->data, f.alpha->size, w, h);
  v.decode(out, stride);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) out[y * stride + 4 * x + 3] = alpha.empty() ? 255 : alpha[static_cast<size_t>(y) * w + x];
}

Frame frame_of(const std::vector<Chunk>& cs) {
  Frame f;
  for (const Chunk& c : cs) {
    if (c.tag == fourcc("ALPH")) {
      if (!f.alpha) f.alpha = &c;
    } else if (c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L")) {
      if (c.tag == fourcc("VP8L") && f.alpha) corrupt("ALPH chunk before a VP8L image");
      f.image = &c;
      return f;
    }
  }
  corrupt("WebP frame without an image chunk");
}

class WebP {
 public:
  WebP(const uint8_t* d, size_t n) {
    if (n < 12 || memcmp(d, "RIFF", 4) != 0 || memcmp(d + 8, "WEBP", 4) != 0) corrupt("not a WebP file");
    const size_t riff = le32(d + 4);
    if (riff < 12) corrupt("bad RIFF size");
    if (riff + 8 > n) corrupt("truncated WebP file");
    top_ = chunks(d + 12, riff - 4);
    if (top_.empty()) corrupt("WebP file without chunks");
    const Chunk& first = top_[0];
    if (first.tag == fourcc("VP8 ") || first.tag == fourcc("VP8L")) {
      frame_.image = &first;
      frame_size(frame_, w_, h_);
      fw_ = w_;
      fh_ = h_;
      return;
    }
    if (first.tag != fourcc("VP8X")) corrupt("WebP file without an image chunk");
    if (first.size < 10) corrupt("bad VP8X chunk");
    const bool anim = first.data[0] & 2;
    w_ = static_cast<int>(le24(first.data + 4)) + 1;
    h_ = static_cast<int>(le24(first.data + 7)) + 1;
    if (static_cast<uint64_t>(w_) * h_ >= (uint64_t(1) << 32)) corrupt("WebP canvas too large");
    if (!anim) {
      for (const Chunk& c : top_)
        if (c.tag == fourcc("ANMF")) corrupt("ANMF chunk in a still WebP file");
      frame_ = frame_of(top_);
      frame_size(frame_, fw_, fh_);
      if (fw_ != w_ || fh_ != h_) corrupt("WebP image size differs from its canvas");
      return;
    }
    for (const Chunk& c : top_) {
      if (c.tag != fourcc("ANMF")) continue;
      if (c.size < 16) corrupt("bad ANMF chunk");
      x_ = 2 * static_cast<int>(le24(c.data));
      y_ = 2 * static_cast<int>(le24(c.data + 3));
      fw_ = static_cast<int>(le24(c.data + 6)) + 1;
      fh_ = static_cast<int>(le24(c.data + 9)) + 1;
      sub_ = chunks(c.data + 16, c.size - 16);
      frame_ = frame_of(sub_);
      int w = 0, h = 0;
      frame_size(frame_, w, h);
      if (w != fw_ || h != fh_) corrupt("ANMF frame size differs from its image");
      if (x_ + fw_ > w_ || y_ + fh_ > h_) corrupt("ANMF frame outside the canvas");
      return;
    }
    corrupt("animated WebP file without frames");
  }

  int width() const { return w_; }
  int height() const { return h_; }

  void decode(uint8_t* out) const {
    const size_t stride = static_cast<size_t>(w_) * 4;
    memset(out, 0, stride * h_);
    decode_frame(frame_, out + static_cast<size_t>(y_) * stride + static_cast<size_t>(x_) * 4, stride);
  }

 private:
  std::vector<Chunk> top_, sub_;
  Frame frame_;
  int w_ = 0, h_ = 0, x_ = 0, y_ = 0, fw_ = 0, fh_ = 0;
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 4) uint8 RGBA, capacity `cap` bytes). With
// `out` null or too small it stops after the headers and returns
// RF_NEED_BUFFER with the size in dims = (H, W). Returns RF_OK or RF_CORRUPT
// (with a message in `err`).
int rf_webp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                   int64_t err_cap) {
  try {
    WebP webp(data, static_cast<size_t>(n));
    dims[0] = webp.height();
    dims[1] = webp.width();
    if (!out || cap < static_cast<int64_t>(webp.height()) * webp.width() * 4) return RF_NEED_BUFFER;
    webp.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("WebP decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
