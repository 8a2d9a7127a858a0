// Native OBJ/MTL scene importer — the runtime's answer to the reference's
// Assimp dependency (reference rayverb/rayverb.cpp:447-461), exposed over a
// plain C ABI for ctypes.
//
// The PyTorch port's own copy of rayverb_tpu/native/objparse.cpp.
//
// Semantics intentionally identical to the Python fallback
// (rayverb_tpu_torch/scene/objloader.py): geometry statements only (v, f,
// usemtl), fan triangulation of polygon faces, 1-based and negative index
// resolution, per-triangle material-name binding. The Python loader is the
// spec; tests assert bit-identical outputs on the demo corpus.
//
// Built by rayverb_tpu_torch/native/__init__.py with g++ into
// rayverb_tpu_torch/_build/ at first use.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct ObjMesh {
    float* vertices;       // 3 * nvertices
    long long nvertices;
    long long* faces;      // 3 * nfaces vertex indices
    int* face_material;    // nfaces indices into the name table
    long long nfaces;
    char* material_names;  // '\0'-joined, nmaterials entries
    long long names_bytes;
    int nmaterials;
    char error[256];
};

static void set_error(ObjMesh* m, const char* msg) {
    std::snprintf(m->error, sizeof(m->error), "%s", msg);
}

ObjMesh* rayverb_load_obj(const char* path) {
    ObjMesh* out = static_cast<ObjMesh*>(std::calloc(1, sizeof(ObjMesh)));
    if (!out) return nullptr;

    FILE* fh = std::fopen(path, "rb");
    if (!fh) {
        set_error(out, "cannot open file");
        return out;
    }
    std::fseek(fh, 0, SEEK_END);
    long size = std::ftell(fh);
    std::fseek(fh, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    if (size > 0 && std::fread(&buf[0], 1, size, fh) != static_cast<size_t>(size)) {
        std::fclose(fh);
        set_error(out, "short read");
        return out;
    }
    std::fclose(fh);

    std::vector<float> verts;
    std::vector<long long> faces;
    std::vector<int> face_mat;
    std::vector<std::string> names;
    std::unordered_map<std::string, int> name_ids;
    int current_mat = -1;  // -1 encodes "no usemtl yet" == empty name

    const char* p = buf.data();
    const char* end = p + buf.size();
    std::vector<long long> poly;

    while (p < end) {
        // skip leading whitespace on the line
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        const char* eol = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!eol) eol = end;

        if (p < eol) {
            if (p[0] == 'v' && (p + 1 < eol) && (p[1] == ' ' || p[1] == '\t')) {
                char* q = const_cast<char*>(p + 1);
                float x = std::strtof(q, &q);
                float y = std::strtof(q, &q);
                float z = std::strtof(q, &q);
                verts.push_back(x);
                verts.push_back(y);
                verts.push_back(z);
            } else if (p[0] == 'f' && (p + 1 < eol) && (p[1] == ' ' || p[1] == '\t')) {
                poly.clear();
                const char* q = p + 1;
                long long nv = static_cast<long long>(verts.size() / 3);
                while (q < eol) {
                    while (q < eol && (*q == ' ' || *q == '\t')) ++q;
                    if (q >= eol) break;
                    char* after = nullptr;
                    long long idx = std::strtoll(q, &after, 10);
                    if (after == q) break;  // not a number
                    q = after;
                    // skip the /vt/vn part of the token
                    while (q < eol && *q != ' ' && *q != '\t') ++q;
                    if (idx > 0) {
                        poly.push_back(idx - 1);
                    } else if (idx < 0) {
                        poly.push_back(nv + idx);
                    } else {
                        std::free(out->vertices);
                        set_error(out, "OBJ face index 0 is invalid");
                        return out;
                    }
                }
                for (size_t k = 1; k + 1 < poly.size(); ++k) {
                    faces.push_back(poly[0]);
                    faces.push_back(poly[k]);
                    faces.push_back(poly[k + 1]);
                    face_mat.push_back(current_mat);
                }
            } else if (eol - p > 7 && std::memcmp(p, "usemtl", 6) == 0 &&
                       (p[6] == ' ' || p[6] == '\t')) {
                const char* q = p + 7;
                while (q < eol && (*q == ' ' || *q == '\t')) ++q;
                const char* e = eol;
                while (e > q && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r'))
                    --e;
                std::string name(q, e);
                auto it = name_ids.find(name);
                if (it == name_ids.end()) {
                    int id = static_cast<int>(names.size());
                    name_ids.emplace(name, id);
                    names.push_back(name);
                    current_mat = id;
                } else {
                    current_mat = it->second;
                }
            } else if (eol - p >= 6 && std::memcmp(p, "usemtl", 6) == 0) {
                current_mat = -1;  // bare 'usemtl' with no name
            }
        }
        p = eol + 1;
    }

    if (verts.empty() || faces.empty()) {
        set_error(out, "OBJ file contains no triangles");
        return out;
    }

    out->nvertices = static_cast<long long>(verts.size() / 3);
    out->vertices = static_cast<float*>(std::malloc(verts.size() * sizeof(float)));
    std::memcpy(out->vertices, verts.data(), verts.size() * sizeof(float));

    out->nfaces = static_cast<long long>(faces.size() / 3);
    out->faces =
        static_cast<long long*>(std::malloc(faces.size() * sizeof(long long)));
    std::memcpy(out->faces, faces.data(), faces.size() * sizeof(long long));
    out->face_material =
        static_cast<int*>(std::malloc(face_mat.size() * sizeof(int)));
    std::memcpy(out->face_material, face_mat.data(),
                face_mat.size() * sizeof(int));

    std::string blob;
    for (const auto& n : names) {
        blob += n;
        blob.push_back('\0');
    }
    out->nmaterials = static_cast<int>(names.size());
    out->names_bytes = static_cast<long long>(blob.size());
    out->material_names = static_cast<char*>(std::malloc(blob.size() + 1));
    std::memcpy(out->material_names, blob.data(), blob.size());
    out->material_names[blob.size()] = '\0';
    out->error[0] = '\0';
    return out;
}

void rayverb_free_obj(ObjMesh* m) {
    if (!m) return;
    std::free(m->vertices);
    std::free(m->faces);
    std::free(m->face_material);
    std::free(m->material_names);
    std::free(m);
}

}  // extern "C"
