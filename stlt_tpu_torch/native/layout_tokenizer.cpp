// Native layout tokenizer: JSON layout datasets → fixed-shape tensors.
//
// The host-side hot path of the input pipeline (the reference does this in
// per-clip Python loops, src/modelling/datasets.py:52-125, plus an O(dataset)
// startup scan at :38-47). This library parses the dataset JSON once into a
// compact arena and fills caller-provided fixed-shape buffers per clip:
// CLS pseudo-box, score thresholding, fix_box repairs (exact semantics of
// src/utils/data_utils.py:205-231), [W,H,W,H] normalization, EXTRACT frame,
// CLS-carrying pad frames.
//
// C API consumed via ctypes from stlt_tpu/data/native.py. Thread-safe for
// concurrent tokenize calls on one parsed handle (read-only after setup).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal recursive-descent JSON parser over an in-memory buffer.
// ---------------------------------------------------------------------------

struct Parser {
  const char* p;
  const char* end;
  std::string error;

  explicit Parser(const std::string& buf) : p(buf.data()), end(buf.data() + buf.size()) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }
  bool fail(const char* msg) {
    if (error.empty()) error = msg;
    return false;
  }

  bool parse_string(std::string* out) {
    skip_ws();
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    out->clear();
    while (p < end && *p != '"') {
      if (*p == '\\') {
        ++p;
        if (p >= end) return fail("bad escape");
        switch (*p) {
          case 'n': out->push_back('\n'); break;
          case 't': out->push_back('\t'); break;
          case 'r': out->push_back('\r'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'u': {
            unsigned cp = 0;
            for (int i = 0; i < 4; ++i) {
              if (p + 1 >= end) return fail("bad \\u escape");
              char c2 = *++p;
              cp <<= 4;
              if (c2 >= '0' && c2 <= '9') cp |= c2 - '0';
              else if (c2 >= 'a' && c2 <= 'f') cp |= c2 - 'a' + 10;
              else if (c2 >= 'A' && c2 <= 'F') cp |= c2 - 'A' + 10;
              else return fail("bad \\u escape");
            }
            if (cp >= 0xD800 && cp <= 0xDBFF && p + 6 < end && p[1] == '\\' &&
                p[2] == 'u') {
              unsigned lo = 0;
              const char* q = p + 2;
              bool ok = true;
              for (int i = 0; i < 4; ++i) {
                char c2 = *++q;
                lo <<= 4;
                if (c2 >= '0' && c2 <= '9') lo |= c2 - '0';
                else if (c2 >= 'a' && c2 <= 'f') lo |= c2 - 'a' + 10;
                else if (c2 >= 'A' && c2 <= 'F') lo |= c2 - 'A' + 10;
                else { ok = false; break; }
              }
              if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                p = q;
              }
            }
            // encode cp as UTF-8
            if (cp < 0x80) out->push_back((char)cp);
            else if (cp < 0x800) {
              out->push_back((char)(0xC0 | (cp >> 6)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            } else if (cp < 0x10000) {
              out->push_back((char)(0xE0 | (cp >> 12)));
              out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            } else {
              out->push_back((char)(0xF0 | (cp >> 18)));
              out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
              out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            }
            break;
          }
          default: out->push_back(*p);
        }
        ++p;
      } else {
        out->push_back(*p++);
      }
    }
    if (p >= end) return fail("unterminated string");
    ++p;
    return true;
  }

  bool parse_number(double* out) {
    skip_ws();
    char* endptr = nullptr;
    *out = std::strtod(p, &endptr);
    if (endptr == p) return fail("expected number");
    p = endptr;
    return true;
  }

  // Skip any JSON value.
  bool skip_value() {
    skip_ws();
    if (p >= end) return fail("eof");
    char c = *p;
    if (c == '"') { std::string s; return parse_string(&s); }
    if (c == '{') {
      ++p;
      if (consume('}')) return true;
      while (true) {
        std::string key;
        if (!parse_string(&key)) return false;
        if (!consume(':')) return fail("expected :");
        if (!skip_value()) return false;
        if (consume('}')) return true;
        if (!consume(',')) return fail("expected , in object");
      }
    }
    if (c == '[') {
      ++p;
      if (consume(']')) return true;
      while (true) {
        if (!skip_value()) return false;
        if (consume(']')) return true;
        if (!consume(',')) return fail("expected , in array");
      }
    }
    if (c == 't') { p += 4; return true; }
    if (c == 'f') { p += 5; return true; }
    if (c == 'n') { p += 4; return true; }
    double d;
    return parse_number(&d);
  }
};

// ---------------------------------------------------------------------------
// Arena
// ---------------------------------------------------------------------------

struct Object {
  // doubles throughout: int-casts and threshold compares must match
  // Python's double semantics exactly (e.g. int(427.9999999))
  double x1, y1, x2, y2, score;
  int32_t category;
};

struct Frame {
  uint32_t obj_start;
  uint32_t obj_count;
};

struct Video {
  uint32_t frame_start;
  uint32_t frame_count;
  float width = 0.f, height = 0.f;
  std::string id;
  std::string meta;  // template (something) or ";"-joined actions (AG)
};

struct Arena {
  std::vector<Object> objects;
  std::vector<Frame> frames;
  std::vector<Video> videos;
  std::string error;
};

bool parse_object_entry(Parser& ps, const std::unordered_map<std::string, int32_t>& vocab,
                        Arena* arena) {
  if (!ps.consume('{')) return ps.fail("expected frame object");
  Object obj{0, 0, 0, 0, 0.0, -1};
  if (!ps.peek('}')) {
    while (true) {
      std::string key;
      if (!ps.parse_string(&key)) return false;
      if (!ps.consume(':')) return ps.fail("expected :");
      if (key == "category") {
        std::string cat;
        if (!ps.parse_string(&cat)) return false;
        auto it = vocab.find(cat);
        obj.category = it == vocab.end() ? -1 : it->second;
      } else if (key == "x1" || key == "y1" || key == "x2" || key == "y2" ||
                 key == "score") {
        double d;
        if (!ps.parse_number(&d)) return false;
        if (key == "x1") obj.x1 = d;
        else if (key == "y1") obj.y1 = d;
        else if (key == "x2") obj.x2 = d;
        else if (key == "y2") obj.y2 = d;
        else obj.score = d;
      } else {
        if (!ps.skip_value()) return false;
      }
      if (ps.consume('}')) break;
      if (!ps.consume(',')) return ps.fail("expected , in frame object");
    }
  } else {
    ps.consume('}');
  }
  arena->objects.push_back(obj);
  return true;
}

bool parse_frame(Parser& ps, const std::unordered_map<std::string, int32_t>& vocab,
                 Arena* arena) {
  if (!ps.consume('{')) return ps.fail("expected frame");
  Frame frame{(uint32_t)arena->objects.size(), 0};
  if (!ps.peek('}')) {
    while (true) {
      std::string key;
      if (!ps.parse_string(&key)) return false;
      if (!ps.consume(':')) return ps.fail("expected :");
      if (key == "frame_objects") {
        if (!ps.consume('[')) return ps.fail("expected frame_objects array");
        if (!ps.peek(']')) {
          while (true) {
            if (!parse_object_entry(ps, vocab, arena)) return false;
            if (ps.consume(']')) break;
            if (!ps.consume(',')) return ps.fail("expected , in frame_objects");
          }
        } else {
          ps.consume(']');
        }
      } else {
        if (!ps.skip_value()) return false;
      }
      if (ps.consume('}')) break;
      if (!ps.consume(',')) return ps.fail("expected , in frame");
    }
  } else {
    ps.consume('}');
  }
  frame.obj_count = (uint32_t)arena->objects.size() - frame.obj_start;
  arena->frames.push_back(frame);
  return true;
}

bool parse_video(Parser& ps, const std::unordered_map<std::string, int32_t>& vocab,
                 Arena* arena) {
  if (!ps.consume('{')) return ps.fail("expected video object");
  Video video;
  video.frame_start = (uint32_t)arena->frames.size();
  video.frame_count = 0;
  if (!ps.peek('}')) {
    while (true) {
      std::string key;
      if (!ps.parse_string(&key)) return false;
      if (!ps.consume(':')) return ps.fail("expected :");
      if (key == "id") {
        if (!ps.parse_string(&video.id)) return false;
      } else if (key == "template") {
        if (!ps.parse_string(&video.meta)) return false;
      } else if (key == "actions") {
        if (!ps.consume('[')) return ps.fail("expected actions array");
        if (!ps.peek(']')) {
          while (true) {
            std::string action;
            if (!ps.parse_string(&action)) return false;
            if (!video.meta.empty()) video.meta.push_back(';');
            video.meta += action;
            if (ps.consume(']')) break;
            if (!ps.consume(',')) return ps.fail("expected , in actions");
          }
        } else {
          ps.consume(']');
        }
      } else if (key == "frames") {
        if (!ps.consume('[')) return ps.fail("expected frames array");
        if (!ps.peek(']')) {
          while (true) {
            if (!parse_frame(ps, vocab, arena)) return false;
            if (ps.consume(']')) break;
            if (!ps.consume(',')) return ps.fail("expected , in frames");
          }
        } else {
          ps.consume(']');
        }
      } else {
        if (!ps.skip_value()) return false;
      }
      if (ps.consume('}')) break;
      if (!ps.consume(',')) return ps.fail("expected , in video");
    }
  } else {
    ps.consume('}');
  }
  video.frame_count = (uint32_t)arena->frames.size() - video.frame_start;
  arena->videos.push_back(std::move(video));
  return true;
}

// fix_box (exact semantics of reference data_utils.py:205-231 /
// stlt_tpu/data/boxes.py).
void fix_box(const double in[4], float height, float width, int out[4]) {
  int x1 = (int)in[0] < 0 ? 0 : (int)in[0];
  int y1 = (int)in[1] < 0 ? 0 : (int)in[1];
  int x2 = (int)in[2] < 0 ? 0 : (int)in[2];
  int y2 = (int)in[3] < 0 ? 0 : (int)in[3];
  if (x1 < 0) x1 = 0;
  if (y1 < 0) y1 = 0;
  if (x2 < 0) x2 = 0;
  if (y2 < 0) y2 = 0;
  if (x1 > x2) std::swap(x1, x2);
  if (y1 > y2) std::swap(y1, y2);
  const int w = (int)width, h = (int)height;
  if (x1 >= w) x1 = w - 1;
  if (x2 >= w) x2 = w - 1;
  if (y1 >= h) y1 = h - 1;
  if (y2 >= h) y2 = h - 1;
  if (x1 == x2 && x1 == 0) x2 = 1;
  if (y1 == y2 && y1 == 0) y2 = 1;
  if (x1 == x2) x1 -= 1;
  if (y1 == y2) y1 -= 1;
  out[0] = x1; out[1] = y1; out[2] = x2; out[3] = y2;
}

}  // namespace

extern "C" {

void* lt_parse(const char* json_path, const char* vocab_json, char* err, int errlen) {
  auto fail = [&](const std::string& msg) -> void* {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
    return nullptr;
  };
  std::ifstream file(json_path, std::ios::binary);
  if (!file) return fail(std::string("cannot open ") + json_path);
  std::string buf((std::istreambuf_iterator<char>(file)),
                  std::istreambuf_iterator<char>());

  // vocab: {"category": id, ...}
  std::unordered_map<std::string, int32_t> vocab;
  const std::string vocab_buf(vocab_json);
  {
    Parser vp{vocab_buf};
    if (!vp.consume('{')) return fail("vocab: expected object");
    if (!vp.peek('}')) {
      while (true) {
        std::string key;
        double val;
        if (!vp.parse_string(&key)) return fail("vocab: " + vp.error);
        if (!vp.consume(':')) return fail("vocab: expected :");
        if (!vp.parse_number(&val)) return fail("vocab: " + vp.error);
        vocab[key] = (int32_t)val;
        if (vp.consume('}')) break;
        if (!vp.consume(',')) return fail("vocab: expected ,");
      }
    }
  }

  auto* arena = new Arena();
  Parser ps{buf};
  if (!ps.consume('[')) { delete arena; return fail("dataset: expected array"); }
  if (!ps.peek(']')) {
    while (true) {
      if (!parse_video(ps, vocab, arena)) {
        std::string msg = "dataset: " + ps.error;
        delete arena;
        return fail(msg);
      }
      if (ps.consume(']')) break;
      if (!ps.consume(',')) { delete arena; return fail("dataset: expected ,"); }
    }
  } else {
    ps.consume(']');
  }
  return arena;
}

int lt_num_videos(void* handle) {
  return (int)static_cast<Arena*>(handle)->videos.size();
}

int lt_video_num_frames(void* handle, int idx) {
  return (int)static_cast<Arena*>(handle)->videos[idx].frame_count;
}

const char* lt_video_id(void* handle, int idx) {
  return static_cast<Arena*>(handle)->videos[idx].id.c_str();
}

const char* lt_video_meta(void* handle, int idx) {
  return static_cast<Arena*>(handle)->videos[idx].meta.c_str();
}

void lt_set_size(void* handle, int idx, float width, float height) {
  auto& v = static_cast<Arena*>(handle)->videos[idx];
  v.width = width;
  v.height = height;
}

int lt_scan_max_objects(void* handle, double threshold) {
  auto* arena = static_cast<Arena*>(handle);
  int max_objects = -1;
  for (const auto& video : arena->videos) {
    for (uint32_t f = 0; f < video.frame_count; ++f) {
      const Frame& frame = arena->frames[video.frame_start + f];
      int count = 0;
      for (uint32_t o = 0; o < frame.obj_count; ++o) {
        if (arena->objects[frame.obj_start + o].score >= threshold) ++count;
      }
      if (count > max_objects) max_objects = count;
    }
  }
  return max_objects;
}

// Fill fixed-shape buffers for one clip. Returns 0 on success, negative on
// error (-1 unknown category, -2 bad index).
int lt_tokenize(void* handle, int video_idx, const int32_t* indices, int n_indices,
                double threshold, int cls_id, int type_pad, int type_regular,
                int type_empty, int type_extract, int num_total_frames,
                int num_boxes, int32_t* categories, float* boxes, float* scores,
                int32_t* frame_types) {
  auto* arena = static_cast<Arena*>(handle);
  if (video_idx < 0 || video_idx >= (int)arena->videos.size()) return -2;
  const Video& video = arena->videos[video_idx];
  const float wh[4] = {video.width, video.height, video.width, video.height};

  // Blank every frame slot: CLS token + zero padding, frame_type = pad.
  for (int f = 0; f < num_total_frames; ++f) {
    int32_t* cat = categories + (size_t)f * num_boxes;
    float* box = boxes + (size_t)f * num_boxes * 4;
    float* sc = scores + (size_t)f * num_boxes;
    std::memset(cat, 0, sizeof(int32_t) * num_boxes);
    std::memset(box, 0, sizeof(float) * num_boxes * 4);
    std::memset(sc, 0, sizeof(float) * num_boxes);
    cat[0] = cls_id;
    box[0] = 0.f; box[1] = 0.f; box[2] = 1.f; box[3] = 1.f;
    sc[0] = 1.f;
    frame_types[f] = type_pad;
  }

  for (int f = 0; f < n_indices; ++f) {
    int idx = indices[f];
    if (idx < 0 || idx >= (int)video.frame_count) return -2;
    const Frame& frame = arena->frames[video.frame_start + idx];
    frame_types[f] = frame.obj_count == 0 ? type_empty : type_regular;
    int slot = 1;
    int32_t* cat = categories + (size_t)f * num_boxes;
    float* box = boxes + (size_t)f * num_boxes * 4;
    float* sc = scores + (size_t)f * num_boxes;
    for (uint32_t o = 0; o < frame.obj_count && slot < num_boxes; ++o) {
      const Object& obj = arena->objects[frame.obj_start + o];
      if (obj.score < threshold) continue;
      if (obj.category < 0) return -1;
      const double raw[4] = {obj.x1, obj.y1, obj.x2, obj.y2};
      int fixed[4];
      fix_box(raw, video.height, video.width, fixed);
      for (int c = 0; c < 4; ++c) box[slot * 4 + c] = fixed[c] / wh[c];
      cat[slot] = obj.category;
      sc[slot] = (float)obj.score;
      ++slot;
    }
  }
  // EXTRACT frame right after the sampled frames (blank slots already carry
  // the CLS token).
  frame_types[n_indices] = type_extract;
  return 0;
}

void lt_free(void* handle) { delete static_cast<Arena*>(handle); }

}  // extern "C"
