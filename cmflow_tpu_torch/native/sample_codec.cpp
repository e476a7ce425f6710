// Fast sample decoder for the VoD scene-flow ujson schema.
//
// Native replacement for the hot host-side path the reference leaves to
// python (ujson.load of ~100-500 KB sample files in DataLoader workers,
// dataset/vod.py:52-53).  A specialized recursive-descent JSON parser
// extracts the numeric fields straight into flat float32 buffers —
// roughly an order of magnitude faster than generic python json decoding
// on the single-core hosts that feed the TPU.
//
// C ABI only (consumed via ctypes; no pybind11 in the image).
//
// Built at first use by cmflow_tpu_torch/native/codec.py:
//   g++ -O3 -shared -fPIC -std=c++17 sample_codec.cpp -o build/native/libsamplecodec-<hash>.so

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit Parser(const char* buf, int64_t len) : p(buf), end(buf + len) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  // Parse a JSON string (assumes no fancy escapes in keys — the schema's
  // keys are plain ASCII identifiers).
  std::string parse_string() {
    std::string s;
    if (!consume('"')) return s;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) ++p;
      s.push_back(*p++);
    }
    if (p < end) ++p;  // closing quote
    return s;
  }

  double parse_number() {
    skip_ws();
    char* out = nullptr;
    double v = strtod(p, &out);
    if (out == p) ok = false;
    p = out;
    return v;
  }

  // Parse any numeric array nest into flat values + inferred shape
  // [rows, cols]; 1-D arrays report cols = 0.
  void parse_numeric_array(std::vector<float>& vals, int64_t& rows,
                           int64_t& cols) {
    rows = 0;
    cols = 0;
    if (!consume('[')) return;
    skip_ws();
    if (peek(']')) {
      ++p;
      return;
    }
    while (ok) {
      skip_ws();
      if (p < end && *p == '[') {  // row of a 2-D array
        ++p;
        int64_t c = 0;
        skip_ws();
        if (!peek(']')) {
          while (ok) {
            vals.push_back(static_cast<float>(parse_number()));
            ++c;
            skip_ws();
            if (p < end && *p == ',') {
              ++p;
              continue;
            }
            break;
          }
        }
        consume(']');
        if (cols == 0) cols = c;
        if (c != cols) ok = false;  // ragged rows unsupported
        ++rows;
      } else {  // scalar element of a 1-D array
        vals.push_back(static_cast<float>(parse_number()));
        ++rows;
      }
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      break;
    }
    consume(']');
  }

  void skip_value();  // forward decl

  void skip_object() {
    if (!consume('{')) return;
    skip_ws();
    if (peek('}')) {
      ++p;
      return;
    }
    while (ok) {
      parse_string();
      consume(':');
      skip_value();
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      break;
    }
    consume('}');
  }

  void skip_array() {
    if (!consume('[')) return;
    skip_ws();
    if (peek(']')) {
      ++p;
      return;
    }
    while (ok) {
      skip_value();
      skip_ws();
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      break;
    }
    consume(']');
  }
};

void Parser::skip_value() {
  skip_ws();
  if (p >= end) {
    ok = false;
    return;
  }
  switch (*p) {
    case '{':
      skip_object();
      break;
    case '[':
      skip_array();
      break;
    case '"':
      parse_string();
      break;
    case 't':
    case 'f':
    case 'n':
      while (p < end && isalpha(*p)) ++p;
      break;
    default:
      parse_number();
  }
}

struct Field {
  std::vector<float> vals;
  int64_t rows = 0;
  int64_t cols = 0;
};

}  // namespace

extern "C" {

struct CmfMat {
  float* data;
  int64_t rows;
  int64_t cols;
};

struct CmfSample {
  CmfMat pc1, pc2, trans, gt_labels, pse_labels, opt_flow;
  CmfMat gt_mask, pse_mask, radar_u, radar_v;
  int32_t ok;
};

static void move_field(Field& f, CmfMat* m) {
  m->rows = f.rows;
  m->cols = f.cols;
  if (f.vals.empty()) {
    m->data = nullptr;
    return;
  }
  m->data = static_cast<float*>(malloc(f.vals.size() * sizeof(float)));
  memcpy(m->data, f.vals.data(), f.vals.size() * sizeof(float));
}

// Parse one sample JSON buffer.  Returns 1 on success.
int cmflow_parse_sample(const char* buf, int64_t len, CmfSample* out) {
  memset(out, 0, sizeof(CmfSample));
  Parser ps(buf, len);
  Field pc1, pc2, trans, gt_labels, pse_labels, opt_flow;
  Field gt_mask, pse_mask, radar_u, radar_v;

  if (!ps.consume('{')) return 0;
  while (ps.ok) {
    std::string key = ps.parse_string();
    ps.consume(':');
    if (key == "pc1") {
      ps.parse_numeric_array(pc1.vals, pc1.rows, pc1.cols);
    } else if (key == "pc2") {
      ps.parse_numeric_array(pc2.vals, pc2.rows, pc2.cols);
    } else if (key == "trans") {
      ps.parse_numeric_array(trans.vals, trans.rows, trans.cols);
    } else if (key == "gt_labels") {
      ps.parse_numeric_array(gt_labels.vals, gt_labels.rows, gt_labels.cols);
    } else if (key == "pse_labels") {
      ps.parse_numeric_array(pse_labels.vals, pse_labels.rows,
                             pse_labels.cols);
    } else if (key == "gt_mask") {
      ps.parse_numeric_array(gt_mask.vals, gt_mask.rows, gt_mask.cols);
    } else if (key == "pse_mask") {
      ps.parse_numeric_array(pse_mask.vals, pse_mask.rows, pse_mask.cols);
    } else if (key == "opt_info") {
      if (!ps.consume('{')) break;
      if (!ps.peek('}')) {
        while (ps.ok) {
          std::string k2 = ps.parse_string();
          ps.consume(':');
          if (k2 == "radar_u") {
            ps.parse_numeric_array(radar_u.vals, radar_u.rows, radar_u.cols);
          } else if (k2 == "radar_v") {
            ps.parse_numeric_array(radar_v.vals, radar_v.rows, radar_v.cols);
          } else if (k2 == "opt_flow") {
            ps.parse_numeric_array(opt_flow.vals, opt_flow.rows,
                                   opt_flow.cols);
          } else {
            ps.skip_value();
          }
          ps.skip_ws();
          if (ps.p < ps.end && *ps.p == ',') {
            ++ps.p;
            continue;
          }
          break;
        }
      }
      ps.consume('}');
    } else {
      ps.skip_value();
    }
    ps.skip_ws();
    if (ps.p < ps.end && *ps.p == ',') {
      ++ps.p;
      continue;
    }
    break;
  }
  ps.consume('}');
  if (!ps.ok) return 0;

  move_field(pc1, &out->pc1);
  move_field(pc2, &out->pc2);
  move_field(trans, &out->trans);
  move_field(gt_labels, &out->gt_labels);
  move_field(pse_labels, &out->pse_labels);
  move_field(opt_flow, &out->opt_flow);
  move_field(gt_mask, &out->gt_mask);
  move_field(pse_mask, &out->pse_mask);
  move_field(radar_u, &out->radar_u);
  move_field(radar_v, &out->radar_v);
  out->ok = 1;
  return 1;
}

void cmflow_free_sample(CmfSample* s) {
  float** mats[] = {
      &s->pc1.data,      &s->pc2.data,      &s->trans.data,
      &s->gt_labels.data, &s->pse_labels.data, &s->opt_flow.data,
      &s->gt_mask.data,  &s->pse_mask.data, &s->radar_u.data,
      &s->radar_v.data,
  };
  for (float** m : mats) {
    free(*m);
    *m = nullptr;
  }
}

}  // extern "C"
