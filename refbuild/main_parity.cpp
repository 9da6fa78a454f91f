// Parity driver for the C++ reference renderer.
//
// Mirrors the reference's source/main.cpp:63-128 but:
//   * camera is selectable (--camera=cornell|dragon; main.cpp hardcodes
//     the PBRT dragon preset at compile time, main.cpp:110)
//   * the environment map is a tiny in-memory BLACK image instead of the
//     missing evening_road_01_puresky_2k.hdr (.MISSING_LARGE_BLOBS:1) —
//     a black sky contributes zero radiance, which the JAX side mirrors
//     by rendering without a sky
//   * output is the RAW linear float framebuffer (RGB32F, row-major,
//     "P6f w h" header) so the python parity test compares pre-tonemap
//     physics, not 8-bit PNG quantization
//
// Build (refbuild/): g++ -O2 -fopenmp -std=c++20 -I../reference/include
//   -Istub -I../reference/rapidobj -I../reference/stbi main_parity.cpp
//   <reference sources except main.cpp/tests.cpp> -o ref_parity
#include <cstdio>
#include <cstring>
#include <iostream>
#include <string>
#include <vector>

#include "bvh.h"
#include "camera.h"
#include "image_io.h"
#include "render_kernel.h"
#include "simple_material.h"
#include "sphere.h"
#include "triangle.h"
#include "utils.h"

int main(int argc, char** argv) {
    std::string obj_path = "/root/reference/data/OBJs/cornell_pbr.obj";
    std::string camera_name = "cornell";
    std::string out_path = "ref_image.f32";
    int width = 128, height = 128, samples = 64, bounces = 8;
    float skyval = 0.5f;
    std::string sky_path;

    for (int i = 1; i < argc; i++) {
        std::string a = argv[i];
        if (a.rfind("--w=", 0) == 0) width = std::atoi(a.c_str() + 4);
        else if (a.rfind("--h=", 0) == 0) height = std::atoi(a.c_str() + 4);
        else if (a.rfind("--samples=", 0) == 0) samples = std::atoi(a.c_str() + 10);
        else if (a.rfind("--bounces=", 0) == 0) bounces = std::atoi(a.c_str() + 10);
        else if (a.rfind("--camera=", 0) == 0) camera_name = a.substr(9);
        else if (a.rfind("--out=", 0) == 0) out_path = a.substr(6);
        else if (a.rfind("--skyval=", 0) == 0) skyval = std::atof(a.c_str() + 9);
        else if (a.rfind("--sky=", 0) == 0) sky_path = a.substr(6);
        else obj_path = a;
    }

    ParsedOBJ parsed_obj = Utils::parse_obj(obj_path);
    std::vector<Sphere> spheres;
    BVH bvh(&parsed_obj.triangles);

    // --sky=<file.hdr>: load a REAL env map through the reference's own
    // reader (main.cpp:86-89) so the env-CDF importance sampling path
    // (utils.cpp:126-142, render_kernel.cpp:532-567) is pinned against a
    // non-constant image.  Default: constant sky (an all-black sky NaNs
    // the reference's env CDF sampling: compute_env_map_cdf total
    // luminance == 0).
    Image skysphere(8, 16, Color(skyval, skyval, skyval));
    if (!sky_path.empty()) {
        int sky_w, sky_h;
        skysphere = Utils::read_image_float(sky_path, sky_w, sky_h);
    }
    std::vector<float> env_map_cdf = Utils::compute_env_map_cdf(skysphere);

    Image image_buffer(width, height);
    RenderKernel kernel(width, height, samples, bounces, image_buffer,
                        parsed_obj.triangles, parsed_obj.materials,
                        parsed_obj.emissive_triangle_indices,
                        parsed_obj.material_indices, spheres, bvh,
                        skysphere, env_map_cdf);
    if (camera_name == "dragon")
        kernel.set_camera(Camera::PBRT_DRAGON_CAMERA);
    else
        kernel.set_camera(Camera::CORNELL_BOX_CAMERA);
    kernel.render();

    FILE* f = std::fopen(out_path.c_str(), "wb");
    if (!f) { std::perror("open out"); return 1; }
    std::fprintf(f, "P6f %d %d\n", width, height);
    for (int i = 0; i < width * height; i++) {
        float rgb[3] = {image_buffer[i].r, image_buffer[i].g,
                        image_buffer[i].b};
        std::fwrite(rgb, sizeof(float), 3, f);
    }
    std::fclose(f);
    std::cout << "wrote " << out_path << std::endl;
    return 0;
}
