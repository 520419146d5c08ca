/* rt_test_host — C host application driving libyuliort.so.
 *
 * The C analog of the reference's rt_test_dll host
 * (rt_test_dll/rt_test_dll.cpp:13-44): build ParamsRT, StartRT a scene
 * file, poll GetCurrentStatusRT, WaitRT, check GetLastErrorRT.
 *
 * Usage: rt_test_host <scene.dae> <libyuliort.so path> [size] [spp]
 * (PYTHONPATH must include the repo root; set YRT_FORCE_CPU=1 to test
 * without a GPU.)
 */
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>

typedef struct {
    int state;
    float progress;
    int lastError;
} YrtStatusRT;

typedef struct {
    const char *renderer;
    int size;
    int depth;
    float tMaxShadowRay;
    int spp;
    float ambientlight[3];
    float eyeSeparation;
    int toeIn;
    float zeroParallax;
    int jpegQuality;
    int debug;
    int threadsPriority;
    int waterMark;
    const char *faceCullingMode;
} YrtParamsRT;

typedef int (*start_fn)(const char *, const YrtParamsRT *);
typedef int (*wait_fn)(void);
typedef int (*err_fn)(void);
typedef void (*status_fn)(YrtStatusRT *);

int main(int argc, char **argv)
{
    if (argc < 3) {
        fprintf(stderr, "usage: %s scene.dae libyuliort.so [size] [spp]\n",
                argv[0]);
        return 2;
    }
    void *lib = dlopen(argv[2], RTLD_NOW | RTLD_GLOBAL);
    if (!lib) {
        fprintf(stderr, "dlopen failed: %s\n", dlerror());
        return 2;
    }
    start_fn StartRT = (start_fn)dlsym(lib, "StartRT");
    wait_fn WaitRT = (wait_fn)dlsym(lib, "WaitRT");
    err_fn GetLastErrorRT = (err_fn)dlsym(lib, "GetLastErrorRT");
    status_fn GetCurrentStatusRT = (status_fn)dlsym(lib,
                                                    "GetCurrentStatusRT");
    if (!StartRT || !WaitRT || !GetLastErrorRT || !GetCurrentStatusRT) {
        fprintf(stderr, "missing symbols\n");
        return 2;
    }

    YrtParamsRT params = {
        .renderer = "pathtracer",
        .size = argc > 3 ? atoi(argv[3]) : 64,
        .depth = 2,
        .tMaxShadowRay = 120.0f,
        .spp = argc > 4 ? atoi(argv[4]) : 2,
        .ambientlight = {0.83f, 0.95f, 0.98f},
        .eyeSeparation = 2.5f,
        .toeIn = 1,
        .zeroParallax = 75.0f,
        .jpegQuality = 90,
        .debug = 0,
        .threadsPriority = 0,
        .waterMark = 0,
        .faceCullingMode = "default",
    };

    if (!StartRT(argv[1], &params)) {
        fprintf(stderr, "StartRT failed: error=%d\n", GetLastErrorRT());
        return 1;
    }
    YrtStatusRT st;
    GetCurrentStatusRT(&st);
    printf("started: state=%d progress=%.2f\n", st.state, st.progress);
    if (!WaitRT()) {
        fprintf(stderr, "WaitRT failed: error=%d\n", GetLastErrorRT());
        return 1;
    }
    GetCurrentStatusRT(&st);
    printf("done: state=%d progress=%.2f lastError=%d\n", st.state,
           st.progress, st.lastError);
    return st.lastError == 0 ? 0 : 1;
}
