// Copy of buas_pathtracer_tpu/native/src/obj_parser.cpp (apart from its
// comments), so the PyTorch port parses OBJ and decodes HDR as the JAX package.
// Native OBJ parser: v/vt/vn records, '/'-separated face corners, negative
// (relative) indices, >3-gon triangle-fan expansion, optional winding flip.
// Native equivalent of the reference's hand-rolled parser
// (Raytracer/assets.cpp:187-400), with the same tolerance
// rules (face with >32 or <3 corners rejects the whole mesh; texcoord/normal
// triangle counts must match the vertex-triangle count or those channels are
// dropped -> here: whole-mesh reject to mirror utils/assets.py).
//
// Handle-based C ABI for ctypes; arrays are float32, triangles as
// (T,3,3) vertex / normal and (T,3,2) texcoord blocks.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjResult {
    std::vector<float> tri;  // (T,3,3)
    std::vector<float> nrm;  // (T,3,3) or empty
    std::vector<float> tex;  // (T,3,2) or empty
    int32_t n_tris = 0;
};

static inline const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static inline const char *next_line(const char *p, const char *end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

// minimal strtof that doesn't touch locale and stops at whitespace
static inline float parse_float(const char *&p, const char *end, bool *ok) {
    char buf[64];
    int i = 0;
    const char *q = p;
    while (q < end && i < 63 &&
           ((*q >= '0' && *q <= '9') || *q == '-' || *q == '+' || *q == '.' ||
            *q == 'e' || *q == 'E')) {
        buf[i++] = *q++;
    }
    buf[i] = 0;
    char *endp = nullptr;
    float v = strtof(buf, &endp);
    *ok = endp != buf;
    p = q;
    return v;
}

static inline int64_t parse_int(const char *&p, const char *end, bool *ok) {
    bool neg = false;
    const char *q = p;
    if (q < end && (*q == '-' || *q == '+')) {
        neg = *q == '-';
        q++;
    }
    int64_t v = 0;
    bool any = false;
    while (q < end && *q >= '0' && *q <= '9') {
        v = v * 10 + (*q - '0');
        q++;
        any = true;
    }
    *ok = any;
    p = q;
    return neg ? -v : v;
}

}  // namespace

extern "C" {

// Parse OBJ text.  flip != 0 reverses winding.  Returns handle or nullptr on
// reject; out params receive triangle count and channel presence.
void *obj_parse(const char *text, int64_t len, int32_t flip, int32_t *n_tris,
                int32_t *has_n, int32_t *has_t) {
    const char *p = text;
    const char *end = text + len;

    // 1-based index convention: slot 0 is a null entry (assets.cpp parser)
    std::vector<float> verts = {0, 0, 0};
    std::vector<float> norms = {0, 0, 0};
    std::vector<float> texs = {0, 0, 0};

    std::vector<int32_t> fv, ft, fn;  // face corner indices, per face
    auto *res = new ObjResult();
    bool reject = false;

    while (p < end && !reject) {
        p = skip_ws(p, end);
        const char *line_end = p;
        while (line_end < end && *line_end != '\n') line_end++;

        if (p + 1 < line_end && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == '\t' || p[1] == 'n' || p[1] == 't')) {
            std::vector<float> *target = &verts;
            const char *q = p + 1;
            if (p[1] == 'n') {
                target = &norms;
                q = p + 2;
            } else if (p[1] == 't') {
                target = &texs;
                q = p + 2;
            }
            float vals[3] = {0, 0, 0};
            for (int i = 0; i < 3; i++) {
                q = skip_ws(q, line_end);
                if (q >= line_end) break;
                bool ok = false;
                float v = parse_float(q, line_end, &ok);
                if (ok) vals[i] = v;
            }
            target->push_back(vals[0]);
            target->push_back(vals[1]);
            target->push_back(vals[2]);
        } else if (p < line_end && p[0] == 'f' &&
                   (p + 1 >= line_end || p[1] == ' ' || p[1] == '\t')) {
            fv.clear();
            ft.clear();
            fn.clear();
            const char *q = p + 1;
            int64_t nv = (int64_t)verts.size() / 3;
            int64_t nt = (int64_t)texs.size() / 3;
            int64_t nn = (int64_t)norms.size() / 3;
            while (true) {
                q = skip_ws(q, line_end);
                if (q >= line_end) break;
                // corner: i[/t[/n]]
                for (int fi = 0; fi < 3; fi++) {
                    bool ok = false;
                    const char *before = q;
                    int64_t idx = parse_int(q, line_end, &ok);
                    if (ok) {
                        int64_t count = fi == 0 ? nv : (fi == 1 ? nt : nn);
                        if (idx < 0) idx = count + idx;
                        if (fi == 0)
                            fv.push_back((int32_t)idx);
                        else if (fi == 1)
                            ft.push_back((int32_t)idx);
                        else
                            fn.push_back((int32_t)idx);
                    }
                    (void)before;
                    if (q < line_end && *q == '/') {
                        q++;
                        continue;
                    }
                    break;
                }
            }
            if (fv.size() > 32 || fv.size() < 3) {  // assets.cpp:262-270
                reject = true;
                break;
            }
            // triangle fan; winding flip swaps corner order (assets.cpp:281)
            int a = flip ? 2 : 0, c = flip ? 0 : 2;
            for (size_t i = 1; i + 1 < fv.size(); i++) {
                int32_t corners[3];
                corners[a] = fv[0];
                corners[1] = fv[i];
                corners[c] = fv[i + 1];
                for (int k = 0; k < 3; k++) {
                    int32_t vi = corners[k];
                    if (vi < 0 || vi >= (int32_t)(verts.size() / 3)) vi = 0;
                    res->tri.push_back(verts[vi * 3 + 0]);
                    res->tri.push_back(verts[vi * 3 + 1]);
                    res->tri.push_back(verts[vi * 3 + 2]);
                }
                if (ft.size() == fv.size()) {
                    corners[a] = ft[0];
                    corners[1] = ft[i];
                    corners[c] = ft[i + 1];
                    for (int k = 0; k < 3; k++) {
                        int32_t vi = corners[k];
                        if (vi < 0 || vi >= (int32_t)(texs.size() / 3)) vi = 0;
                        res->tex.push_back(texs[vi * 3 + 0]);
                        res->tex.push_back(texs[vi * 3 + 1]);
                    }
                }
                if (fn.size() == fv.size()) {
                    corners[a] = fn[0];
                    corners[1] = fn[i];
                    corners[c] = fn[i + 1];
                    for (int k = 0; k < 3; k++) {
                        int32_t vi = corners[k];
                        if (vi < 0 || vi >= (int32_t)(norms.size() / 3)) vi = 0;
                        res->nrm.push_back(norms[vi * 3 + 0]);
                        res->nrm.push_back(norms[vi * 3 + 1]);
                        res->nrm.push_back(norms[vi * 3 + 2]);
                    }
                }
                res->n_tris++;
            }
        }
        p = next_line(line_end, end);
    }

    if (reject || res->n_tris == 0) {
        delete res;
        return nullptr;
    }
    // channel counts must match triangle count, else reject (assets.py:82-85)
    bool hn = res->nrm.size() == (size_t)res->n_tris * 9;
    bool htex = res->tex.size() == (size_t)res->n_tris * 6;
    if (!hn && !res->nrm.empty()) {
        delete res;
        return nullptr;
    }
    if (!htex && !res->tex.empty()) {
        delete res;
        return nullptr;
    }
    *n_tris = res->n_tris;
    *has_n = hn ? 1 : 0;
    *has_t = htex ? 1 : 0;
    return res;
}

void obj_fetch(void *handle, float *tri, float *nrm, float *tex) {
    auto *res = static_cast<ObjResult *>(handle);
    std::memcpy(tri, res->tri.data(), res->tri.size() * sizeof(float));
    if (nrm && !res->nrm.empty())
        std::memcpy(nrm, res->nrm.data(), res->nrm.size() * sizeof(float));
    if (tex && !res->tex.empty())
        std::memcpy(tex, res->tex.data(), res->tex.size() * sizeof(float));
}

void obj_release(void *handle) { delete static_cast<ObjResult *>(handle); }

// Radiance HDR RLE scanline decode (adaptive 0x0202 streams + flat rows).
// Native equivalent of the reference Raytracer/assets.cpp:406-618; RGBE
// bytes out, float decode stays vectorized numpy.  Returns 0 on success.
int32_t hdr_decode(const uint8_t *buf, int64_t len, int32_t w, int32_t h,
                   uint8_t *out /* (h,w,4) */) {
    int64_t at = 0;
    for (int32_t y = 0; y < h; y++) {
        if (at + 4 > len) return -1;
        uint8_t *row = out + (int64_t)y * w * 4;
        if (w >= 8 && w < 32768 && buf[at] == 2 && buf[at + 1] == 2 &&
            ((int32_t)buf[at + 2] << 8 | buf[at + 3]) == w) {
            at += 4;
            for (int comp = 0; comp < 4; comp++) {
                int32_t x = 0;
                while (x < w) {
                    if (at >= len) return -1;
                    int32_t count = buf[at++];
                    if (count > 128) {  // run
                        count -= 128;
                        if (at >= len || x + count > w) return -1;
                        uint8_t v = buf[at++];
                        for (int32_t k = 0; k < count; k++)
                            row[(x + k) * 4 + comp] = v;
                        x += count;
                    } else {  // literal
                        if (at + count > len || x + count > w) return -1;
                        for (int32_t k = 0; k < count; k++)
                            row[(x + k) * 4 + comp] = buf[at + k];
                        at += count;
                        x += count;
                    }
                }
            }
        } else {
            if (at + (int64_t)w * 4 > len) return -1;
            std::memcpy(row, buf + at, (size_t)w * 4);
            at += (int64_t)w * 4;
        }
    }
    return 0;
}

}  // extern "C"
