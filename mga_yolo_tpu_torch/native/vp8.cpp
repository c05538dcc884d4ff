// VP8 (RFC 6386) on the host: a decoder that keeps its state from frame to
// frame, for the VP8 video of WebM and Matroska files (data/video_io.py),
// and the key frame of a lossy WebP still (webp.cpp).
//
// Video: what ffmpeg's vp8 decoder computes for each frame, which cv2 then
// converts. Key frames and inter frames: the frame header with segmentation
// (a segment map that persists while it is not updated), loop filter deltas
// by reference frame and mode, token partitions, the golden and alt-ref
// refreshes and copies (from the references before this frame), their sign
// biases, refresh_entropy_probs (the probabilities saved and put back after
// a frame that sets it to 0) and refresh_last; the 16x16, chroma and MV
// probability updates; per macroblock the intra modes (contextual 4x4 mode
// probabilities on key frames, fixed ones on inter frames), the reference,
// find_near_mvs with sign-bias inversion and the mode contexts, the MV trees
// (short and long forms), SPLITMV (16x8, 8x16, 8x8, 4x4 with left and above
// sub-MV contexts) and the clamping of near, nearest and best MVs; six-tap
// sub-pixel prediction (bilinear for versions 1 to 3, chroma full-pixel for
// version 3) from references whose edges repeat without end; chroma MVs from
// the average of four luma MVs; the loop filter's levels (hev thresholds
// for inter frames) and its rule that skips the inner edges of a macroblock
// with no coefficients that is neither B_PRED nor SPLITMV. A frame with
// show_frame 0 is decoded and not output, as ffmpeg does. The reconstruction
// and filters are libwebp's formulation, bit-exact with libvpx and ffmpeg.
//
// Still (WebP): a key frame alone, with libwebp's test for a macroblock
// without coefficients; webp.cpp upsamples and converts it.
//
// Cut or corrupt data is refused with a message (libavcodec conceals it),
// never read past its end. No global state: a decoder owns its frames.
//
// Exposed (extern "C"):
//   mga_vp8_new / mga_vp8_free - a video decoder
//   mga_vp8_decode             - one frame (a block of the container)
//   mga_vp8_planes             - the last shown frame's I420 planes, cropped
//   mga_vp8_tally              - counts of the features decoded so far
//   mga_vp8_still              - a WebP still's key frame, for webp.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Fail {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg}; }

// VP8's constant tables (RFC 6386): the dequantisation steps, the key
// frame's 4x4 intra mode probabilities and the coefficient probabilities.

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
static const uint8_t kBModesProba[10][10][9] = {
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
    112, 19, 12, 61, 195, 128, 48, 4, 24};
static const uint8_t kCoeffsProba0[4][8][3][11] = {
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
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
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
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0}, kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's order of the 4x4 intra modes; the 16x16 and chroma modes use DC, TM, VE, HE
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
// The inter frame's constant tables (RFC 6386 sections 16 to 18).
const uint8_t kYModeProbInter[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbInter[3] = {162, 101, 204};
const uint8_t kBModeProbInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
// per component (row, column): is short, sign, the short tree, the long bits
const uint8_t kMvProbDefault[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const uint8_t kMvProbUpdate[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},    {14, 18, 14, 107},   {135, 64, 57, 68},
                                     {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kSubMvProb[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
enum { SPLIT_16x8, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE };
// the partition of each 4x4 block, and each partition's first block
const uint8_t kSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                                {0}};
const uint8_t kSplitCount[4] = {2, 2, 4, 16};
const uint8_t kSplitFirst[4][16] = {
    {0, 8}, {0, 2}, {0, 2, 8, 10}, {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const int kSixtap[8][6] = {{0, 0, 128, 0, 0, 0},     {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
                           {0, -9, 93, 50, -6, 0},   {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
                           {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

// What a decoder counts (mga_vp8_tally), in this order; data/video_io.py
// names them.
enum Tally {
    T_FRAMES, T_KEY, T_INTER, T_HIDDEN, T_INTRA16_INTER, T_BPRED_INTER, T_ZEROMV, T_NEARESTMV, T_NEARMV,
    T_NEWMV, T_SPLIT_16x8, T_SPLIT_8x16, T_SPLIT_8x8, T_SPLIT_4x4, T_REF_LAST, T_REF_GOLDEN, T_REF_ALTREF,
    T_SIGN_BIAS_FLIP, T_REFRESH_GOLDEN, T_REFRESH_ALTREF, T_COPY_GOLDEN, T_COPY_ALTREF, T_ENTROPY_SAVED,
    T_NO_REFRESH_LAST, T_SEGMENTED, T_SEGMENT_MAP_UPDATES, T_PARTITIONED, T_SUBPEL_SIXTAP, T_SUBPEL_BILINEAR,
    T_EDGE_EMULATED, T_MV_CLAMPED, T_MV_LONG, T_LF_DELTAS, T_INNER_EDGES_SKIPPED, T_MODE_PROB_UPDATES,
    T_MV_PROB_UPDATES, T_SIMPLE_FILTER, T_SUBMV_LEFT, T_SUBMV_ABOVE, T_SUBMV_ZERO, T_SUBMV_NEW,
    T_GOLDEN_SIGN_BIAS, T_ALTREF_SIGN_BIAS, T_FULL_PIXEL, T_COUNT
};

// RFC 6386's boolean decoder. Like libwebp's (its "premature end of file"),
// it is at its end once a bit is asked for when every bit of its n bytes has
// been shifted in: that is, more than 8 (n - 1) shifts before the call.
struct BoolDec {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint32_t value = 0;
    int range = 255, count = 0;
    int64_t shifts = 0, limit = 0;
    bool at_end = false;

    void init(const uint8_t* data, int64_t n) {
        p = data;
        end = data + n;
        range = 255;
        count = 0;
        shifts = 0;
        limit = 8 * (n - 1);
        at_end = n == 0;
        value = (uint32_t)byte() << 8;
        value |= byte();
    }
    uint32_t byte() { return p < end ? *p++ : 0; }
    int get(int prob) {
        if (shifts > limit) at_end = true;
        uint32_t split = 1 + (((uint32_t)(range - 1) * (uint32_t)prob) >> 8);
        uint32_t big = split << 8;
        int bit;
        if (value >= big) {
            range -= (int)split;
            value -= big;
            bit = 1;
        } else {
            range = (int)split;
            bit = 0;
        }
        while (range < 128) {
            value <<= 1;
            range <<= 1;
            ++shifts;
            if (++count == 8) {
                count = 0;
                value |= byte();
            }
        }
        return bit;
    }
    int lit(int n) {
        int v = 0;
        while (n--) v = (v << 1) | get(128);
        return v;
    }
    int signed_lit(int n) {
        int v = lit(n);
        return get(128) ? -v : v;
    }
    bool eof() const { return at_end; }
};

struct Mv {
    int16_t x = 0, y = 0;
};
inline bool same(Mv a, Mv b) { return a.x == b.x && a.y == b.y; }
inline bool is_zero(Mv a) { return !a.x && !a.y; }

struct MbInfo {
    uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
    uint8_t imodes[16] = {0};  // the 4x4 modes, or the 16x16 mode in [0]
    uint8_t ref = 0;           // 0 intra, 1 last, 2 golden, 3 alt-ref
    uint8_t is_split = 0, is_zero_mv = 0, partitioning = SPLIT_NONE;
    Mv mv;
    Mv bmv[16];  // per partition
};

struct Frame {
    std::vector<uint8_t> Y, U, V;
};
using FramePtr = std::shared_ptr<Frame>;

struct Probs {
    uint8_t coef[4][8][3][11];
    uint8_t ymode[4], uvmode[3];
    uint8_t mv[2][19];
};

struct Vp8 {
    bool still = false;  // WebP: libwebp's rule for a macroblock without coefficients
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    int key = 0, version = 0, show = 0;
    BoolDec br;
    std::vector<BoolDec> parts;
    // header
    int use_segment = 0, update_map = 0, absolute_delta = 0;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    int seg_probs[3] = {255, 255, 255};
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    int filter_type = 0;
    int dq[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
    Probs probs, saved;
    int refresh_entropy = 1, refresh_golden = 0, refresh_alt = 0, copy_golden = 0, copy_alt = 0, refresh_last = 1;
    int sign_bias[4] = {0};
    int use_skip = 0, skip_p = 0, prob_intra = 0, prob_last = 0, prob_gf = 0;
    // frames
    int ystride = 0, uvstride = 0;
    FramePtr cur, last, golden, alt;
    std::vector<MbInfo> mbs;
    std::vector<uint8_t> segmap;
    std::vector<uint8_t> fl_limit, fl_ilevel, fl_hev, fl_inner;
    int64_t tally[T_COUNT] = {0};

    static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

    void reset_probs() {
        std::memcpy(probs.coef, kCoeffsProba0, sizeof(probs.coef));
        std::memcpy(probs.ymode, kYModeProbInter, sizeof(probs.ymode));
        std::memcpy(probs.uvmode, kUvModeProbInter, sizeof(probs.uvmode));
        std::memcpy(probs.mv, kMvProbDefault, sizeof(probs.mv));
    }

    void headers(const uint8_t* data, int64_t n) {
        if (still && n < 10) fail("truncated VP8 header");
        if (n < 3) fail("truncated VP8 frame (" + std::to_string(n) + " bytes)");
        uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
        key = !(bits & 1);
        version = (bits >> 1) & 7;
        show = (bits >> 4) & 1;
        uint32_t part0 = bits >> 5;
        if (still && !key) fail("VP8 data that is not a key frame");
        if (version > 3) fail("VP8 profile " + std::to_string(version));
        if (still && !show) fail("VP8 frame not displayable");
        if (key) {
            if (n < 10) fail("truncated VP8 header");
            if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8 start code missing");
            const int w = (data[6] | (data[7] << 8)) & 0x3fff, h = (data[8] | (data[9] << 8)) & 0x3fff;
            if (!w || !h) fail("VP8 frame of no pixels");
            if (width && (w != width || h != height))
                fail("VP8 frame size changes from " + std::to_string(width) + "x" + std::to_string(height) + " to " +
                     std::to_string(w) + "x" + std::to_string(h));
            width = w;
            height = h;
            data += 10;
            n -= 10;
            // a key frame resets the probabilities, segmentation, loop filter deltas and sign biases
            reset_probs();
            use_segment = update_map = absolute_delta = 0;
            std::memset(quantizer, 0, sizeof(quantizer));
            std::memset(filter_strength, 0, sizeof(filter_strength));
            std::memset(ref_lf_delta, 0, sizeof(ref_lf_delta));
            std::memset(mode_lf_delta, 0, sizeof(mode_lf_delta));
            sign_bias[2] = sign_bias[3] = 0;
        } else {
            if (!last) fail("a VP8 inter frame before the first key frame");
            data += 3;
            n -= 3;
        }
        if (part0 > (uint64_t)n) fail("truncated VP8 data (first partition)");
        br.init(data, part0);
        const uint8_t* rest = data + part0;
        int64_t rest_n = n - part0;
        if (key) {
            br.get(128);  // colour space
            br.get(128);  // clamping type: the pixels are clamped either way
        }
        use_segment = br.get(128);
        update_map = 0;
        if (use_segment) {
            ++tally[T_SEGMENTED];
            update_map = br.get(128);
            if (br.get(128)) {
                absolute_delta = br.get(128);
                for (int s = 0; s < 4; ++s) quantizer[s] = br.get(128) ? br.signed_lit(7) : 0;
                for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(128) ? br.signed_lit(6) : 0;
            }
            if (update_map) {
                ++tally[T_SEGMENT_MAP_UPDATES];
                for (int s = 0; s < 3; ++s) seg_probs[s] = br.get(128) ? br.lit(8) : 255;
            }
        }
        simple = br.get(128);
        level = br.lit(6);
        sharpness = br.lit(3);
        use_lf_delta = br.get(128);
        if (use_lf_delta && br.get(128)) {
            for (int i = 0; i < 4; ++i)
                if (br.get(128)) ref_lf_delta[i] = br.signed_lit(6);
            for (int i = 0; i < 4; ++i)
                if (br.get(128)) mode_lf_delta[i] = br.signed_lit(6);
        }
        if (use_lf_delta) ++tally[T_LF_DELTAS];
        filter_type = level == 0 ? 0 : simple ? 1 : 2;
        if (filter_type == 1) ++tally[T_SIMPLE_FILTER];
        if (br.eof()) fail("truncated VP8 header");
        // token partitions
        const int nparts = 1 << br.lit(2);
        if (nparts > 1) ++tally[T_PARTITIONED];
        if (rest_n < 3 * (nparts - 1)) fail("truncated VP8 data (partition sizes)");
        const uint8_t* sz = rest;
        const uint8_t* start = rest + 3 * (nparts - 1);
        int64_t left = rest_n - 3 * (nparts - 1);
        parts.assign(nparts, BoolDec());
        for (int p = 0; p < nparts - 1; ++p) {
            int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > left) psize = left;
            parts[p].init(start, psize);
            start += psize;
            left -= psize;
            sz += 3;
        }
        if (left <= 0) fail("truncated VP8 data (token partitions)");
        parts[nparts - 1].init(start, left);
        // quantisers
        const int base_q = br.lit(7);
        int d[5];
        for (int i = 0; i < 5; ++i) d[i] = br.get(128) ? br.signed_lit(4) : 0;
        for (int s = 0; s < 4; ++s) {
            int q = base_q;
            if (use_segment) q = quantizer[s] + (absolute_delta ? 0 : base_q);
            else if (s > 0) {
                std::memcpy(dq[s], dq[0], sizeof(dq[0]));
                continue;
            }
            dq[s][0][0] = kDcTable[clip(q + d[0], 127)];
            dq[s][0][1] = kAcTable[clip(q, 127)];
            dq[s][1][0] = kDcTable[clip(q + d[1], 127)] * 2;
            dq[s][1][1] = (kAcTable[clip(q + d[2], 127)] * 101581) >> 16;
            if (dq[s][1][1] < 8) dq[s][1][1] = 8;
            dq[s][2][0] = kDcTable[clip(q + d[3], 117)];
            dq[s][2][1] = kAcTable[clip(q + d[4], 127)];
        }
        refresh_golden = refresh_alt = key;
        copy_golden = copy_alt = 0;
        if (!key) {
            refresh_golden = br.get(128);
            refresh_alt = br.get(128);
            if (!refresh_golden) copy_golden = br.lit(2);
            if (!refresh_alt) copy_alt = br.lit(2);
            sign_bias[2] = br.get(128);
            sign_bias[3] = br.get(128);
            tally[T_REFRESH_GOLDEN] += refresh_golden;
            tally[T_REFRESH_ALTREF] += refresh_alt;
            tally[T_COPY_GOLDEN] += copy_golden != 0;
            tally[T_COPY_ALTREF] += copy_alt != 0;
            tally[T_GOLDEN_SIGN_BIAS] += sign_bias[2];
            tally[T_ALTREF_SIGN_BIAS] += sign_bias[3];
        }
        refresh_entropy = br.get(128);
        if (!refresh_entropy) {
            saved = probs;
            ++tally[T_ENTROPY_SAVED];
        }
        refresh_last = key || br.get(128);
        if (!refresh_last) ++tally[T_NO_REFRESH_LAST];
        for (int t = 0; t < 4; ++t)
            for (int b = 0; b < 8; ++b)
                for (int c = 0; c < 3; ++c)
                    for (int p = 0; p < 11; ++p)
                        if (br.get(kCoeffsUpdateProba[t][b][c][p])) probs.coef[t][b][c][p] = (uint8_t)br.lit(8);
        use_skip = br.get(128);
        skip_p = use_skip ? br.lit(8) : 0;
        if (!key) {
            prob_intra = br.lit(8);
            prob_last = br.lit(8);
            prob_gf = br.lit(8);
            if (br.get(128)) {
                ++tally[T_MODE_PROB_UPDATES];
                for (int i = 0; i < 4; ++i) probs.ymode[i] = (uint8_t)br.lit(8);
            }
            if (br.get(128)) {
                ++tally[T_MODE_PROB_UPDATES];
                for (int i = 0; i < 3; ++i) probs.uvmode[i] = (uint8_t)br.lit(8);
            }
            for (int i = 0; i < 2; ++i)
                for (int j = 0; j < 19; ++j)
                    if (br.get(kMvProbUpdate[i][j])) {
                        const int v = br.lit(7) << 1;
                        probs.mv[i][j] = (uint8_t)(v ? v : 1);
                        ++tally[T_MV_PROB_UPDATES];
                    }
        }
        if (version == 3) ++tally[T_FULL_PIXEL];
        if (br.eof()) fail("truncated VP8 header");
    }

    // ---- per macroblock modes (first partition)

    void segment_and_skip(MbInfo& mb, size_t i) {
        if (update_map) {
            mb.segment = !br.get(seg_probs[0]) ? br.get(seg_probs[1]) : br.get(seg_probs[2]) + 2;
            segmap[i] = mb.segment;
        } else {
            mb.segment = segmap[i];  // persists from the frame that last updated it
        }
        if (use_skip) mb.skip = br.get(skip_p);
    }

    void read_bmodes(MbInfo& mb, uint8_t* top, uint8_t* left) {
        for (int y = 0; y < 4; ++y) {
            int ymode = left ? left[y] : 0;
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = key ? kBModesProba[top[x]][ymode] : kBModeProbInter;
                ymode = !br.get(prob[0])   ? B_DC
                        : !br.get(prob[1]) ? B_TM
                        : !br.get(prob[2]) ? B_VE
                        : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                                           : (!br.get(prob[6]) ? B_LD
                                              : !br.get(prob[7]) ? B_VL
                                              : !br.get(prob[8]) ? B_HD
                                                                 : B_HU);
                if (key) top[x] = (uint8_t)ymode;
                mb.imodes[y * 4 + x] = (uint8_t)ymode;
            }
            if (key) left[y] = (uint8_t)ymode;
        }
    }

    void intra_modes(MbInfo& mb, uint8_t* top, uint8_t* left) {
        mb.is_i4x4 = !br.get(145);
        if (!mb.is_i4x4) {
            int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
            mb.imodes[0] = (uint8_t)ymode;
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            read_bmodes(mb, top, left);
        }
        mb.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
    }

    void inter_intra_modes(MbInfo& mb) {
        const uint8_t* p = probs.ymode;
        if (!br.get(p[0])) mb.imodes[0] = B_DC;
        else if (!br.get(p[1])) mb.imodes[0] = br.get(p[2]) ? B_HE : B_VE;
        else if (!br.get(p[3])) mb.imodes[0] = B_TM;
        else mb.is_i4x4 = 1;
        if (mb.is_i4x4) {
            read_bmodes(mb, nullptr, nullptr);
            ++tally[T_BPRED_INTER];
        } else {
            ++tally[T_INTRA16_INTER];
        }
        const uint8_t* q = probs.uvmode;
        mb.uvmode = !br.get(q[0]) ? B_DC : !br.get(q[1]) ? B_VE : !br.get(q[2]) ? B_HE : B_TM;
    }

    int mv_component(const uint8_t* p) {
        int x = 0;
        if (br.get(p[0])) {
            ++tally[T_MV_LONG];
            for (int i = 0; i < 3; ++i) x += br.get(p[9 + i]) << i;
            for (int i = 9; i > 3; --i) x += br.get(p[9 + i]) << i;
            if (!(x & 0xFFF0) || br.get(p[9 + 3])) x += 8;
        } else {
            const uint8_t* ps = p + 2;
            int bit = br.get(*ps);
            ps += 1 + 3 * bit;
            x += 4 * bit;
            bit = br.get(*ps);
            ps += 1 + bit;
            x += 2 * bit;
            x += br.get(*ps);
        }
        return (x && br.get(p[1])) ? -x : x;
    }

    Mv clamp_mv(Mv v, int mb_x, int mb_y) {
        auto c16 = [](int a) { return a < -32768 ? -32768 : a > 32767 ? 32767 : a; };
        const int min_x = c16(-64 - 64 * mb_x), max_x = c16(64 * (mb_w - 1 - mb_x) + 64);
        const int min_y = c16(-64 - 64 * mb_y), max_y = c16(64 * (mb_h - 1 - mb_y) + 64);
        Mv out;
        out.x = (int16_t)(v.x < min_x ? min_x : v.x > max_x ? max_x : v.x);
        out.y = (int16_t)(v.y < min_y ? min_y : v.y > max_y ? max_y : v.y);
        if (!same(out, v)) ++tally[T_MV_CLAMPED];
        return out;
    }

    int split_mvs(MbInfo& mb, const MbInfo& left, const MbInfo& top) {
        const int part = br.get(110) ? (br.get(111) ? SPLIT_16x8 + br.get(150) : SPLIT_8x8) : SPLIT_4x4;
        ++tally[T_SPLIT_16x8 + part];
        const int num = kSplitCount[part];
        const uint8_t* cur = kSplits[part];
        const uint8_t* ls = kSplits[left.partitioning];
        const uint8_t* ts = kSplits[top.partitioning];
        mb.partitioning = (uint8_t)part;
        for (int n = 0; n < num; ++n) {
            const int k = kSplitFirst[part][n];
            const Mv l = (k & 3) ? mb.bmv[cur[k - 1]] : left.bmv[ls[k + 3]];
            const Mv a = k > 3 ? mb.bmv[cur[k - 4]] : top.bmv[ts[k + 12]];
            const uint8_t* sp = same(l, a) ? kSubMvProb[is_zero(l) ? 4 : 3]
                                : is_zero(a) ? kSubMvProb[2]
                                             : kSubMvProb[is_zero(l) ? 1 : 0];
            if (!br.get(sp[0])) {
                mb.bmv[n] = l;
                ++tally[T_SUBMV_LEFT];
            } else if (!br.get(sp[1])) {
                mb.bmv[n] = a;
                ++tally[T_SUBMV_ABOVE];
            } else if (!br.get(sp[2])) {
                mb.bmv[n] = Mv();
                ++tally[T_SUBMV_ZERO];
            } else {
                const int dy = mv_component(probs.mv[0]);
                const int dx = mv_component(probs.mv[1]);
                mb.bmv[n].y = (int16_t)(mb.mv.y + dy);
                mb.bmv[n].x = (int16_t)(mb.mv.x + dx);
                ++tally[T_SUBMV_NEW];
            }
        }
        return num;
    }

    void inter_modes(MbInfo& mb, int mb_x, int mb_y) {
        static const MbInfo outside;
        const size_t i = (size_t)mb_y * mb_w + mb_x;
        mb.ref = br.get(prob_last) ? (br.get(prob_gf) ? 3 : 2) : 1;
        ++tally[T_REF_LAST + mb.ref - 1];
        const MbInfo& top = mb_y > 0 ? mbs[i - mb_w] : outside;
        const MbInfo& left = mb_x > 0 ? mbs[i - 1] : outside;
        const MbInfo& top_left = mb_x > 0 && mb_y > 0 ? mbs[i - mb_w - 1] : outside;
        const MbInfo* edge[3] = {&top, &left, &top_left};
        Mv near[4];
        int cnt[4] = {0, 0, 0, 0}, idx = 0;
        for (int n = 0; n < 3; ++n) {
            const MbInfo& e = *edge[n];
            if (!e.ref) continue;
            Mv v = e.mv;
            if (!is_zero(v)) {
                if (sign_bias[mb.ref] != sign_bias[e.ref]) {
                    v.x = (int16_t)-v.x;
                    v.y = (int16_t)-v.y;
                    ++tally[T_SIGN_BIAS_FLIP];
                }
                if (n == 0 || !same(v, near[idx])) near[++idx] = v;
                cnt[idx] += n == 2 ? 1 : 2;
            } else {
                cnt[0] += n == 2 ? 1 : 2;
            }
        }
        if (!br.get(kModeContexts[cnt[0]][0])) {
            mb.is_zero_mv = 1;
            mb.mv = mb.bmv[0] = Mv();
            ++tally[T_ZEROMV];
            return;
        }
        if (cnt[3] && same(near[1], near[3])) cnt[1] += 1;  // three distinct MVs: merge the first and the last
        if (cnt[2] > cnt[1]) {
            std::swap(cnt[1], cnt[2]);
            std::swap(near[1], near[2]);
        }
        if (!br.get(kModeContexts[cnt[1]][1])) {
            mb.mv = mb.bmv[0] = clamp_mv(near[1], mb_x, mb_y);
            ++tally[T_NEARESTMV];
        } else if (!br.get(kModeContexts[cnt[2]][2])) {
            mb.mv = mb.bmv[0] = clamp_mv(near[2], mb_x, mb_y);
            ++tally[T_NEARMV];
        } else {
            mb.mv = clamp_mv(near[cnt[1] >= cnt[0] ? 1 : 0], mb_x, mb_y);  // the best MV
            const int c = (left.is_split + top.is_split) * 2 + top_left.is_split;
            if (br.get(kModeContexts[c][3])) {
                mb.is_split = 1;
                mb.mv = mb.bmv[split_mvs(mb, left, top) - 1];
            } else {
                const int dy = mv_component(probs.mv[0]);
                const int dx = mv_component(probs.mv[1]);
                mb.mv.y = (int16_t)(mb.mv.y + dy);
                mb.mv.x = (int16_t)(mb.mv.x + dx);
                mb.bmv[0] = mb.mv;
                ++tally[T_NEWMV];
            }
        }
    }

    // ---- residuals

    static int large_value(BoolDec& b, const uint8_t* p) {
        int v;
        if (!b.get(p[3])) {
            v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
        } else if (!b.get(p[6])) {
            if (!b.get(p[7])) {
                v = 5 + b.get(159);
            } else {
                v = 7 + 2 * b.get(165);
                v += b.get(145);
            }
        } else {
            const int bit1 = b.get(p[8]);
            const int bit0 = b.get(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    // The coefficients of one 4x4 block from position n on, dequantised,
    // into out (natural order); returns the position after the last token.
    int coeffs(BoolDec& b, int type, int ctx, const int* q, int n, int16_t* out) {
        const uint8_t* p = probs.coef[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!b.get(p[0])) return n;
            while (!b.get(p[1])) {
                p = probs.coef[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            if (!b.get(p[2])) {
                v = 1;
                p = probs.coef[type][kBands[n + 1]][1];
            } else {
                v = large_value(b, p);
                p = probs.coef[type][kBands[n + 1]][2];
            }
            const int s = b.get(128) ? -v : v;
            out[kZigzag[n]] = (int16_t)(s * q[n > 0]);
        }
        return 16;
    }

    static void wht(const int16_t* in, int16_t* out) {
        int tmp[16];
        for (int i = 0; i < 4; ++i) {
            const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
            const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
            tmp[0 + i] = a0 + a1;
            tmp[8 + i] = a0 - a1;
            tmp[4 + i] = a3 + a2;
            tmp[12 + i] = a3 - a2;
        }
        for (int i = 0; i < 4; ++i) {
            const int dc = tmp[0 + i * 4] + 3;
            const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
            const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
            out[0] = (int16_t)((a0 + a1) >> 3);
            out[16] = (int16_t)((a3 + a2) >> 3);
            out[32] = (int16_t)((a0 - a1) >> 3);
            out[48] = (int16_t)((a3 - a2) >> 3);
            out += 64;
        }
    }

    static uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
    // in 64 bits: the products overflow 32 only on corrupt coefficients, where libwebp's C is undefined
    static int mul1(int a) { return (int)(((int64_t)a * 20091) >> 16) + a; }
    static int mul2(int a) { return (int)(((int64_t)a * 35468) >> 16); }

    // the inverse DCT of in, added to the 4x4 pixels at dst (stride bps)
    static void idct_add(const int16_t* in, uint8_t* dst, int bps) {
        int C[16], *tmp = C;
        for (int i = 0; i < 4; ++i) {
            const int a = in[0] + in[8], b = in[0] - in[8];
            const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
            tmp[0] = a + d;
            tmp[1] = b + c;
            tmp[2] = b - c;
            tmp[3] = a - d;
            tmp += 4;
            ++in;
        }
        tmp = C;
        for (int i = 0; i < 4; ++i) {
            const int dc = tmp[0] + 4;
            const int a = dc + tmp[8], b = dc - tmp[8];
            const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
            dst[0] = clip8(dst[0] + ((a + d) >> 3));
            dst[1] = clip8(dst[1] + ((b + c) >> 3));
            dst[2] = clip8(dst[2] + ((b - c) >> 3));
            dst[3] = clip8(dst[3] + ((a - d) >> 3));
            ++tmp;
            dst += bps;
        }
    }

    // The dequantised coefficients of a macroblock into co (25 blocks of 16);
    // returns whether it has none: libwebp's test for a still (per block,
    // tokens past the second position or a non-zero DC, a 16x16 block's DC
    // from the WHT), ffmpeg's for video (no coefficient token at all).
    bool residuals(MbInfo& mb, BoolDec& tb, uint8_t* tnz, uint8_t* lnz, int16_t* co) {
        std::memset(co, 0, 25 * 16 * sizeof(int16_t));
        const int(*q)[2] = dq[mb.segment];
        const bool y2 = !mb.is_i4x4 && !mb.is_split;
        if (mb.skip) {
            for (int i = 0; i < 8; ++i) tnz[i] = lnz[i] = 0;
            if (y2) tnz[8] = lnz[8] = 0;
            return true;
        }
        bool any = false;
        int total = 0;
        int first = 0, ytype = 3;
        if (y2) {
            int16_t dc[16] = {0};
            const int ctx = tnz[8] + lnz[8];
            const int nz = coeffs(tb, 1, ctx, q[1], 0, dc);
            tnz[8] = lnz[8] = nz > 0;
            total += nz;
            wht(dc, co);
            first = 1;
            ytype = 0;
        }
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
                int16_t* blk = co + (y * 4 + x) * 16;
                const int nz = coeffs(tb, ytype, tnz[x] + lnz[y], q[0], first, blk);
                tnz[x] = lnz[y] = nz > first;
                total += nz > first ? nz : 0;
                any = any || nz > 1 || blk[0] != 0;
            }
        for (int ch = 0; ch < 2; ++ch)
            for (int y = 0; y < 2; ++y)
                for (int x = 0; x < 2; ++x) {
                    uint8_t& t = tnz[4 + ch * 2 + x];
                    uint8_t& l = lnz[4 + ch * 2 + y];
                    int16_t* blk = co + (16 + ch * 4 + y * 2 + x) * 16;
                    const int nz = coeffs(tb, 2, t + l, q[2], 0, blk);
                    t = l = nz > 0;
                    total += nz;
                    any = any || nz > 1 || blk[0] != 0;
                }
        return still ? !any : total == 0;
    }

    // ---- intra prediction on a work buffer of stride BPS, dst at (0, 0) with row -1 and column -1 filled
    static constexpr int BPS = 32;
    static uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
    static uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

    static void pred_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
        const uint8_t* top = dst - BPS;
        if (mode == B_DC) {
            int dc;
            const int shift = size == 16 ? 4 : 3;
            if (mb_x > 0 && mb_y > 0) {
                dc = size;
                for (int i = 0; i < size; ++i) dc += top[i] + dst[i * BPS - 1];
                dc >>= shift + 1;
            } else if (mb_y > 0) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += top[i];
                dc >>= shift;
            } else if (mb_x > 0) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += dst[i * BPS - 1];
                dc >>= shift;
            } else {
                dc = 0x80;
            }
            for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dc, size);
        } else if (mode == B_VE) {
            for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, top, size);
        } else if (mode == B_HE) {
            for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
        } else {  // TrueMotion
            const int tl = top[-1];
            for (int y = 0; y < size; ++y)
                for (int x = 0; x < size; ++x) dst[y * BPS + x] = clip8(top[x] + dst[y * BPS - 1] - tl);
        }
    }

    static void pred4(uint8_t* dst, int mode) {
#define DST(x, y) dst[(x) + (y) * BPS]
        const uint8_t* t = dst - BPS;
        const int X = t[-1], A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6], H = t[7];
        const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1], L = dst[3 * BPS - 1];
        switch (mode) {
            case B_DC: {
                int dc = 4;
                for (int i = 0; i < 4; ++i) dc += t[i] + dst[i * BPS - 1];
                dc >>= 3;
                for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc, 4);
                break;
            }
            case B_TM:
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x) DST(x, y) = clip8(t[x] + dst[y * BPS - 1] - X);
                break;
            case B_VE: {
                const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
                for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
                break;
            }
            case B_HE: {
                const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
                for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
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
                DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
                break;
            default:  // B_HD
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
        }
#undef DST
    }


    // ---- inter prediction: the block at (x, y) + the MV in ref (aligned
    // size pw x ph, stride pw), its edges repeated without end, into dst
    // (stride BPS); (fx, fy) the eighth-pixel fraction.
    void predict(uint8_t* dst, const uint8_t* ref, int pw, int ph, int x, int y, int bw, int bh, int fx, int fy) {
        uint8_t win[(16 + 5) * (16 + 5)];
        const int ws = bw + 5;
        const bool bilinear = version != 0;
        // the window from (x - 2, y - 2), clamped to the plane
        const bool inside = x - 2 >= 0 && y - 2 >= 0 && x + bw + 3 <= pw && y + bh + 3 <= ph;
        if (!inside) ++tally[T_EDGE_EMULATED];
        for (int r = 0; r < bh + 5; ++r) {
            const int yy = clip(y - 2 + r, ph - 1);
            const uint8_t* row = ref + (size_t)yy * pw;
            uint8_t* w = win + r * ws;
            if (inside) {
                std::memcpy(w, row + x - 2, ws);
            } else {
                for (int c = 0; c < ws; ++c) w[c] = row[clip(x - 2 + c, pw - 1)];
            }
        }
        if (!fx && !fy) {
            for (int r = 0; r < bh; ++r) std::memcpy(dst + r * BPS, win + (r + 2) * ws + 2, bw);
            return;
        }
        int tmp[(16 + 5) * 16];
        if (bilinear) {
            ++tally[T_SUBPEL_BILINEAR];
            for (int r = 0; r < bh + 1; ++r)
                for (int c = 0; c < bw; ++c) {
                    const uint8_t* s = win + (r + 2) * ws + c + 2;
                    tmp[r * 16 + c] = (s[0] * (8 - fx) + s[1] * fx + 4) >> 3;
                }
            for (int r = 0; r < bh; ++r)
                for (int c = 0; c < bw; ++c)
                    dst[r * BPS + c] = (uint8_t)((tmp[r * 16 + c] * (8 - fy) + tmp[(r + 1) * 16 + c] * fy + 4) >> 3);
            return;
        }
        ++tally[T_SUBPEL_SIXTAP];
        const int* h = kSixtap[fx];
        const int* v = kSixtap[fy];
        for (int r = 0; r < bh + 5; ++r)
            for (int c = 0; c < bw; ++c) {
                const uint8_t* s = win + r * ws + c;
                tmp[r * 16 + c] = fx ? clip8((h[0] * s[0] + h[1] * s[1] + h[2] * s[2] + h[3] * s[3] + h[4] * s[4] +
                                              h[5] * s[5] + 64) >> 7)
                                     : s[2];
            }
        for (int r = 0; r < bh; ++r)
            for (int c = 0; c < bw; ++c) {
                const int* t = tmp + r * 16 + c;
                dst[r * BPS + c] = fy ? clip8((v[0] * t[0] + v[1] * t[16] + v[2] * t[32] + v[3] * t[48] +
                                               v[4] * t[64] + v[5] * t[80] + 64) >> 7)
                                      : (uint8_t)t[32];
            }
    }

    // the macroblock's prediction from its reference into yd, ud, vd (stride BPS)
    void inter_predict(const MbInfo& mb, int mb_x, int mb_y, uint8_t* yd, uint8_t* ud, uint8_t* vd) {
        const Frame& ref = *(mb.ref == 1 ? last : mb.ref == 2 ? golden : alt);
        const int pw = mb_w * 16, ph = mb_h * 16, cw = mb_w * 8, chh = mb_h * 8;
        const int x0 = mb_x * 16, y0 = mb_y * 16;
        auto luma = [&](Mv m, int bx, int by, int size) {
            predict(yd + by * BPS + bx, ref.Y.data(), pw, ph, x0 + bx + (m.x >> 2), y0 + by + (m.y >> 2), size, size,
                    (m.x * 2) & 7, (m.y * 2) & 7);
        };
        auto chroma = [&](Mv m, int bx, int by, int size) {
            if (version == 3) {  // full-pixel chroma
                m.x = (int16_t)(m.x & ~7);
                m.y = (int16_t)(m.y & ~7);
            }
            const int x = x0 / 2 + bx + (m.x >> 3), y = y0 / 2 + by + (m.y >> 3);
            predict(ud + by * BPS + bx, ref.U.data(), cw, chh, x, y, size, size, m.x & 7, m.y & 7);
            predict(vd + by * BPS + bx, ref.V.data(), cw, chh, x, y, size, size, m.x & 7, m.y & 7);
        };
        if (!mb.is_split) {
            luma(mb.mv, 0, 0, 16);
            chroma(mb.mv, 0, 0, 8);
            return;
        }
        const uint8_t* part = kSplits[mb.partitioning];
        for (int b = 0; b < 16; ++b) luma(mb.bmv[part[b]], (b & 3) * 4, (b >> 2) * 4, 4);
        for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
                int sx = 0, sy = 0;
                for (int k = 0; k < 4; ++k) {
                    const Mv m = mb.bmv[part[(2 * y + (k >> 1)) * 4 + 2 * x + (k & 1)]];
                    sx += m.x;
                    sy += m.y;
                }
                Mv m;  // the average, rounded as ffmpeg rounds it
                m.x = (int16_t)((sx + 2 + (sx >> 31)) >> 2);
                m.y = (int16_t)((sy + 2 + (sy >> 31)) >> 2);
                chroma(m, x * 4, y * 4, 4);
            }
    }

    // Residuals and reconstruction of macroblock (mb_x, mb_y) into the
    // (unfiltered) current frame; returns whether it had no coefficient.
    bool macroblock(int mb_x, int mb_y, MbInfo& mb, BoolDec& tb, uint8_t* tnz, uint8_t* lnz) {
        int16_t co[25 * 16];
        const bool none = residuals(mb, tb, tnz, lnz, co);
        uint8_t* Y = cur->Y.data();
        uint8_t* U = cur->U.data();
        uint8_t* V = cur->V.data();
        // the work buffers: row -1 and column -1 around the block, four more pixels top right
        uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
        uint8_t* yd = ybuf + BPS + 1;
        uint8_t* ud = ubuf + BPS + 1;
        uint8_t* vd = vbuf + BPS + 1;
        const int x0 = mb_x * 16, y0 = mb_y * 16;
        if (mb.ref) {
            inter_predict(mb, mb_x, mb_y, yd, ud, vd);
            for (int n = 0; n < 16; ++n) idct_add(co + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
        } else {
            for (int pl = 0; pl < 3; ++pl) {
                uint8_t* d = pl == 0 ? yd : pl == 1 ? ud : vd;
                const int size = pl == 0 ? 16 : 8, stride = pl == 0 ? ystride : uvstride;
                const uint8_t* plane = pl == 0 ? Y : pl == 1 ? U : V;
                const int px = mb_x * size, py = mb_y * size;
                for (int j = 0; j < size; ++j)
                    d[j * BPS - 1] = mb_x > 0 ? plane[(size_t)(py + j) * stride + px - 1] : 129;
                if (mb_y > 0) {
                    std::memcpy(d - BPS, plane + (size_t)(py - 1) * stride + px, size);
                    d[-BPS - 1] = mb_x > 0 ? plane[(size_t)(py - 1) * stride + px - 1] : 129;
                } else {
                    std::memset(d - BPS - 1, 127, size + 1 + (pl == 0 ? 4 : 0));
                }
            }
            if (mb.is_i4x4) {
                uint8_t* tr = yd - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1) std::memset(tr, Y[(size_t)(y0 - 1) * ystride + x0 + 15], 4);
                    else std::memcpy(tr, Y + (size_t)(y0 - 1) * ystride + x0 + 16, 4);
                }
                for (int r = 1; r < 4; ++r) std::memcpy(tr + 4 * r * BPS, tr, 4);
                for (int n = 0; n < 16; ++n) {
                    uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                    pred4(dst, mb.imodes[n]);
                    idct_add(co + n * 16, dst, BPS);
                }
            } else {
                pred_block(yd, 16, mb.imodes[0], mb_x, mb_y);
                for (int n = 0; n < 16; ++n) idct_add(co + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
            }
            pred_block(ud, 8, mb.uvmode, mb_x, mb_y);
            pred_block(vd, 8, mb.uvmode, mb_x, mb_y);
        }
        for (int n = 0; n < 4; ++n) {
            idct_add(co + (16 + n) * 16, ud + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
            idct_add(co + (20 + n) * 16, vd + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
        }
        for (int j = 0; j < 16; ++j) std::memcpy(Y + (size_t)(y0 + j) * ystride + x0, yd + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            std::memcpy(U + (size_t)(mb_y * 8 + j) * uvstride + mb_x * 8, ud + j * BPS, 8);
            std::memcpy(V + (size_t)(mb_y * 8 + j) * uvstride + mb_x * 8, vd + j * BPS, 8);
        }
        return none;
    }

    // ---- loop filters (RFC 6386 section 15, libwebp's formulation)
    static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
    static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
    static void filter2(uint8_t* p, int s) {
        const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
        const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
        const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
        p[-s] = clip8(p0 + a2);
        p[0] = clip8(q0 - a1);
    }
    static void filter4(uint8_t* p, int s) {
        const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
        const int a = 3 * (q0 - p0);
        const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
        p[-2 * s] = clip8(p1 + a3);
        p[-s] = clip8(p0 + a2);
        p[0] = clip8(q0 - a1);
        p[s] = clip8(q1 - a3);
    }
    static void filter6(uint8_t* p, int s) {
        const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
        const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
        const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
        p[-3 * s] = clip8(p2 + a3);
        p[-2 * s] = clip8(p1 + a2);
        p[-s] = clip8(p0 + a1);
        p[0] = clip8(q0 - a1);
        p[s] = clip8(q1 - a2);
        p[2 * s] = clip8(q2 - a3);
    }
    static bool hev(const uint8_t* p, int s, int t) {
        return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
    }
    static bool needs(const uint8_t* p, int s, int t) {
        return 4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t;
    }
    static bool needs2(const uint8_t* p, int s, int t, int it) {
        const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
        const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
        if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
        return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
               std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
    }
    static void simple_edge(uint8_t* p, int hs, int vs, int thresh) {  // 16 pixels along vs
        const int t2 = 2 * thresh + 1;
        for (int i = 0; i < 16; ++i, p += vs)
            if (needs(p, hs, t2)) filter2(p, hs);
    }
    static void edge(uint8_t* p, int hs, int vs, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
        const int t2 = 2 * thresh + 1;
        for (int i = 0; i < size; ++i, p += vs) {
            if (!needs2(p, hs, t2, ithresh)) continue;
            if (hev(p, hs, hev_t)) filter2(p, hs);
            else if (mb_edge) filter6(p, hs);
            else filter4(p, hs);
        }
    }


    void loop_filter() {
        uint8_t* Yp = cur->Y.data();
        uint8_t* Up = cur->U.data();
        uint8_t* Vp = cur->V.data();
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const size_t i = (size_t)mb_y * mb_w + mb_x;
                const int limit = fl_limit[i];
                if (limit == 0) continue;
                const int il = fl_ilevel[i], hv = fl_hev[i];
                const bool inner = fl_inner[i];
                uint8_t* y = Yp + (size_t)mb_y * 16 * ystride + mb_x * 16;
                uint8_t* u = Up + (size_t)mb_y * 8 * uvstride + mb_x * 8;
                uint8_t* v = Vp + (size_t)mb_y * 8 * uvstride + mb_x * 8;
                if (filter_type == 1) {
                    if (mb_x > 0) simple_edge(y, 1, ystride, limit + 4);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ystride, limit);
                    if (mb_y > 0) simple_edge(y, ystride, 1, limit + 4);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) simple_edge(y + k * ystride, ystride, 1, limit);
                } else {
                    if (mb_x > 0) {
                        edge(y, 1, ystride, 16, limit + 4, il, hv, true);
                        edge(u, 1, uvstride, 8, limit + 4, il, hv, true);
                        edge(v, 1, uvstride, 8, limit + 4, il, hv, true);
                    }
                    if (inner) {
                        for (int k = 4; k < 16; k += 4) edge(y + k, 1, ystride, 16, limit, il, hv, false);
                        edge(u + 4, 1, uvstride, 8, limit, il, hv, false);
                        edge(v + 4, 1, uvstride, 8, limit, il, hv, false);
                    }
                    if (mb_y > 0) {
                        edge(y, ystride, 1, 16, limit + 4, il, hv, true);
                        edge(u, uvstride, 1, 8, limit + 4, il, hv, true);
                        edge(v, uvstride, 1, 8, limit + 4, il, hv, true);
                    }
                    if (inner) {
                        for (int k = 4; k < 16; k += 4) edge(y + k * ystride, ystride, 1, 16, limit, il, hv, false);
                        edge(u + 4 * uvstride, uvstride, 1, 8, limit, il, hv, false);
                        edge(v + 4 * uvstride, uvstride, 1, 8, limit, il, hv, false);
                    }
                }
            }
    }

    // the loop filter's strength for a macroblock: its segment's level with
    // the deltas of its reference and mode (ffmpeg's filter_level_for_mb)
    void filter_strength_of(const MbInfo& mb, bool none, size_t i) {
        int lv = level;
        if (use_segment) lv = filter_strength[mb.segment] + (absolute_delta ? 0 : level);
        if (use_lf_delta) {
            lv += ref_lf_delta[mb.ref];
            if (mb.is_i4x4) lv += mode_lf_delta[0];
            else if (mb.ref) lv += mode_lf_delta[mb.is_zero_mv ? 1 : mb.is_split ? 3 : 2];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        fl_limit[i] = fl_ilevel[i] = fl_hev[i] = 0;
        fl_inner[i] = mb.is_i4x4 || mb.is_split || !none;
        if (!fl_inner[i]) ++tally[T_INNER_EDGES_SKIPPED];
        if (lv == 0) return;
        int il = lv;
        if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        fl_ilevel[i] = (uint8_t)il;
        fl_limit[i] = (uint8_t)(2 * lv + il);
        fl_hev[i] = key ? (lv >= 40 ? 2 : lv >= 15 ? 1 : 0) : (lv >= 40 ? 3 : lv >= 20 ? 2 : lv >= 15 ? 1 : 0);
    }

    void allocate() {
        mb_w = (width + 15) >> 4;
        mb_h = (height + 15) >> 4;
        ystride = mb_w * 16;
        uvstride = mb_w * 8;
        const size_t nmb = (size_t)mb_w * mb_h;
        if (segmap.size() != nmb) segmap.assign(nmb, 0);
        fl_limit.assign(nmb, 0);
        fl_ilevel.assign(nmb, 0);
        fl_hev.assign(nmb, 0);
        fl_inner.assign(nmb, 0);
        mbs.assign(nmb, MbInfo());
        // a fresh buffer, or one no reference holds any more
        if (!cur || cur.use_count() > 1) cur = std::make_shared<Frame>();
        cur->Y.assign((size_t)ystride * mb_h * 16, 0);
        cur->U.assign((size_t)uvstride * mb_h * 8, 0);
        cur->V.assign(cur->U.size(), 0);
    }

    void decode_frame() {
        allocate();
        std::vector<uint8_t> intra_t((size_t)mb_w * 4, B_DC);
        std::vector<uint8_t> top_nz((size_t)mb_w * 9, 0);
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
            uint8_t left_nz[9] = {0};
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const size_t i = (size_t)mb_y * mb_w + mb_x;
                MbInfo& mb = mbs[i];
                segment_and_skip(mb, i);
                if (key) intra_modes(mb, intra_t.data() + 4 * mb_x, intra_l);
                else if (br.get(prob_intra)) inter_modes(mb, mb_x, mb_y);
                else inter_intra_modes(mb);
            }
            if (br.eof()) fail("truncated VP8 data (first partition)");
            BoolDec& tb = parts[mb_y & (parts.size() - 1)];
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const size_t i = (size_t)mb_y * mb_w + mb_x;
                MbInfo& mb = mbs[i];
                const bool none = macroblock(mb_x, mb_y, mb, tb, top_nz.data() + 9 * mb_x, left_nz);
                if (tb.eof()) fail("truncated VP8 data (token partition)");
                if (filter_type > 0) filter_strength_of(mb, none, i);
            }
        }
        if (filter_type > 0) loop_filter();
    }

    // One frame of a video: returns whether it is shown.
    bool decode(const uint8_t* data, int64_t n) {
        headers(data, n);
        decode_frame();
        if (!refresh_entropy) probs = saved;
        ++tally[T_FRAMES];
        ++tally[key ? T_KEY : T_INTER];
        if (!show) ++tally[T_HIDDEN];
        // the references, each from those before this frame (as ffmpeg updates them)
        if (key) {
            last = golden = alt = cur;
        } else {
            FramePtr g = refresh_golden ? cur : copy_golden == 1 ? last : copy_golden == 2 ? alt : golden;
            FramePtr a = refresh_alt ? cur : copy_alt == 1 ? last : copy_alt == 2 ? golden : alt;
            golden = g;
            alt = a;
            if (refresh_last) last = cur;
        }
        shown = cur;
        return show;
    }

    FramePtr shown;
};

int run(char* err, int errlen, const std::function<void()>& fn) {
    try {
        fn();
        return 0;
    } catch (const Fail& f) {
        std::snprintf(err, errlen, "%s", f.msg.c_str());
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory");
    }
    return -1;
}

}  // namespace

extern "C" {

void* mga_vp8_new() { return new (std::nothrow) Vp8(); }

void mga_vp8_free(void* h) { delete static_cast<Vp8*>(h); }

// One VP8 frame (a block's payload). Returns 1 for a shown frame (info:
// width, height, key), 0 for a hidden one, -1 with the reason.
int mga_vp8_decode(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
    Vp8& d = *static_cast<Vp8*>(h);
    bool shown = false;
    if (run(err, errlen, [&] { shown = d.decode(data, n); })) return -1;
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.key;
    return shown ? 1 : 0;
}

// The last shown frame's planes, cropped: y (h, w), u and v ((h + 1) / 2, (w + 1) / 2).
void mga_vp8_planes(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
    const Vp8& d = *static_cast<const Vp8*>(h);
    if (!d.shown) return;
    const int w = d.width, hh = d.height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
    for (int r = 0; r < hh; ++r) std::memcpy(y + (size_t)r * w, d.shown->Y.data() + (size_t)r * d.ystride, w);
    for (int r = 0; r < ch; ++r) {
        std::memcpy(u + (size_t)r * cw, d.shown->U.data() + (size_t)r * d.uvstride, cw);
        std::memcpy(v + (size_t)r * cw, d.shown->V.data() + (size_t)r * d.uvstride, cw);
    }
}

// A lossy WebP's VP8 key frame of w x h pixels into planes at its
// macroblock-aligned size: y of ((w + 15) / 16 * 16) columns and
// ((h + 15) / 16 * 16) rows, u and v of half both. Returns 0, or -1 with the
// reason.
int mga_vp8_still(const uint8_t* data, int64_t n, int32_t w, int32_t h, uint8_t* y, uint8_t* u, uint8_t* v, char* err,
                  int errlen) {
    return run(err, errlen, [&] {
        Vp8 d;
        d.still = true;
        d.headers(data, n);
        if (d.width != w || d.height != h) fail("VP8 frame size differs from its header");
        d.decode_frame();
        std::memcpy(y, d.cur->Y.data(), d.cur->Y.size());
        std::memcpy(u, d.cur->U.data(), d.cur->U.size());
        std::memcpy(v, d.cur->V.data(), d.cur->V.size());
    });
}

// Up to n of the decoder's counts (the Tally enum's order); returns how many it has.
int mga_vp8_tally(void* h, int64_t* out, int n) {
    const Vp8& d = *static_cast<const Vp8*>(h);
    for (int i = 0; i < n && i < T_COUNT; ++i) out[i] = d.tally[i];
    return T_COUNT;
}

}  // extern "C"
