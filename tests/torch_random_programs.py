"""Random EVA programs and compiler configurations for either package.

A helper module with no tests of its own. `random_program` and
`random_config` are tests/test_fuzz.py's generators with the DSL package
(eva_tpu or eva_tpu_torch) passed in: on the same `random.Random` state
they draw exactly what test_fuzz draws, so the same seed gives the same
program in both packages. This module imports neither package, so a
script on the card (tools/fuzz_cuda.py, chip_smoke.py) uses it with
eva_tpu_torch alone.

`random_case_wide` draws what the narrow generator never does: vector
sizes up to 8192 (the compiler then picks N from 8192 to 32768, and
shards a vector wider than N/2), all four rescalers, the security levels
128/192/256 with and without quantum safety, a second key-switch prime
entry (`two_entry_ks`: four key primes instead of two), the key-switch
route (fused, or EVA_TPU_NO_FUSED_KS=1 for the structured one) and the
digit size alpha (the default n_key, or EVA_TPU_KS_ALPHA=1). It never
draws alpha > n_key: there the device digits differ from the host's in
the reference itself (ROADMAP.md Queue 3)."""

from __future__ import annotations

import contextlib
import os
import random

RESCALERS = ("always", "minimum", "lazy_waterline", "eager_waterline")
WIDE_VEC_SIZES = (4, 16, 64, 256, 1024, 2048, 4096, 8192)
# Rescalers that are not general: the compiler raises this for a program
# they cannot handle (CKKSCompiler._validate).
_NOT_GENERAL = "rescaler produced inconsistent parameters"
# The crypto layer finds no NTT-friendly sub-prime pair for the chain.
_NO_CHAIN = "No sub-prime pair found"
# Draws before random_case_wide gives up on a ring size: N=32768, the
# rarest, comes from ~2% of draws (counted over 2000 draws).
MAX_DRAWS = 2000


def random_program(pkg, rng: random.Random, index: int, vec_size=None):
    """test_fuzz.random_program with the DSL of `pkg`; `vec_size` None
    draws it from [4, 8, 16, 32] as test_fuzz does."""
    if vec_size is None:
        vec_size = rng.choice([4, 8, 16, 32])
    prog = pkg.EvaProgram(f"fuzz{index}", vec_size=vec_size)
    with prog:
        pool = []
        n_inputs = rng.randint(1, 3)
        for i in range(n_inputs):
            pool.append(pkg.Input(f"x{i}", rng.random() < 0.8))
        for _ in range(rng.randint(3, 12)):
            kind = rng.random()
            a = rng.choice(pool)
            if kind < 0.25:
                b = rng.choice(pool)
                pool.append(a + b if rng.random() < 0.5 else a - b)
            elif kind < 0.5:
                # multiply by term, constant, or scalar
                pick = rng.random()
                if pick < 0.5:
                    pool.append(a * rng.choice(pool))
                elif pick < 0.75:
                    pool.append(a * round(rng.uniform(-3, 3), 3))
                else:
                    pool.append(a * [round(rng.uniform(-2, 2), 3)
                                     for _ in range(vec_size)])
            elif kind < 0.65:
                pool.append(-a)
            elif kind < 0.85:
                steps = rng.randint(-vec_size, vec_size)
                pool.append(a << steps if rng.random() < 0.5 else a >> steps)
            else:
                pool.append(a ** rng.randint(1, 3))
        n_outputs = rng.randint(1, 2)
        for j in range(n_outputs):
            pkg.Output(f"y{j}", rng.choice(pool[-5:]))
    prog.set_output_ranges(30)
    prog.set_input_scales(rng.choice([25, 30, 40]))
    return prog


def random_config(rng: random.Random) -> dict:
    return {
        "rescaler": rng.choice(["lazy_waterline", "eager_waterline"]),
        "balance_reductions": rng.choice(["true", "false"]),
        "lazy_relinearize": rng.choice(["true", "false"]),
        "warn_vec_size": "false",
    }


def random_config_wide(rng: random.Random):
    """(compiler config, environment) for one program: any of the four
    rescalers, a security level, quantum safety, one or two key-switch
    prime entries, the key-switch route and alpha."""
    config = {
        "rescaler": rng.choice(RESCALERS),
        "balance_reductions": rng.choice(["true", "false"]),
        "lazy_relinearize": rng.choice(["true", "false"]),
        "security_level": rng.choice(["128", "192", "256"]),
        "quantum_safe": rng.choice(["true", "false"]),
        "two_entry_ks": rng.choice(["true", "false", "false"]),
        "warn_vec_size": "false",
    }
    env = {}
    if rng.random() < 0.5:
        env["EVA_TPU_NO_FUSED_KS"] = "1"
    if rng.random() < 0.5:
        env["EVA_TPU_KS_ALPHA"] = "1"
    return config, env


def random_case_wide(pkg, rng: random.Random, index: int, ring=None):
    """(program, config, env, compiled): a program of random_program at a
    vector size from WIDE_VEC_SIZES under random_config_wide, compiled by
    `pkg`'s CKKSCompiler; with `ring`, the first draw whose compile picks
    N = ring. A program that "always" or "minimum" cannot handle (they
    are not general) falls back to "lazy_waterline", so those two appear
    only on programs they support. A compile whose prime chain the
    crypto layer cannot build is drawn again (ROADMAP.md Queue 3: three
    40-bit entries at N=32768 find no sub-prime pair, in both packages).
    `compiled` is the (program, params, signature) triple."""
    from importlib import import_module
    compiler = import_module(pkg.__name__ + ".ckks").CKKSCompiler
    # The package's context cache: the run that follows reuses the chain.
    get_context = import_module(pkg.__name__ + ".crypto.context").get_context
    for _ in range(MAX_DRAWS):
        vec_size = rng.choice(WIDE_VEC_SIZES)
        prog = random_program(pkg, rng, index, vec_size)
        config, env = random_config_wide(rng)
        try:
            compiled = compiler(dict(config)).compile(prog)
        except RuntimeError as exc:
            if _NOT_GENERAL not in str(exc):
                raise
            config["rescaler"] = "lazy_waterline"
            compiled = compiler(dict(config)).compile(prog)
        params = compiled[1]
        if ring is not None and params.poly_modulus_degree != ring:
            continue
        try:
            get_context(tuple(params.prime_bits), tuple(params.rotations),
                        params.poly_modulus_degree, params.key_terms)
        except RuntimeError as exc:
            if _NO_CHAIN not in str(exc):
                raise
            continue
        return prog, config, env, compiled
    raise RuntimeError(f"random_case_wide: no program at N={ring} in "
                       f"{MAX_DRAWS} draws")


@contextlib.contextmanager
def environment(env: dict):
    """Set the variables of `env` for the duration, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the reference's program matrices ----------------------------------------
# tests/test_he.py:14-150 (without TestNoiseEstimator) and the
# regressions of tests/test_large.py:40-130, each case one program: its
# builder takes the DSL package. One program of the reference's loops
# (test_unary's four operations, test_rotations' two shifts) is one case
# here.

class Case:
    """One program of the matrices: `build(pkg)` returns the program;
    `config` is the compiler config; `inputs(prog)` the input values (the
    reference's uniform(-2, 2) draws unless the test gave its own, drawn
    here with numpy from a seed of the case's name); `group` "he_ops"
    (test_he.py's binary, unary, rotation and mixed cases), "he_rest" (the
    rest of test_he.py) or "large" (test_large.py)."""

    def __init__(self, name, build, config=None, inputs=None,
                 group="he_rest"):
        self.name, self.build, self.group = name, build, group
        self.config = {"warn_vec_size": "false", **(config or {})}
        self._inputs = inputs

    def inputs(self, prog):
        if self._inputs is not None:
            return self._inputs(prog.vec_size)
        import numpy as np
        rng = np.random.default_rng(sum(map(ord, self.name)))
        return {k: rng.uniform(-2, 2, prog.vec_size).tolist()
                for k in prog.inputs}


def _program(pkg, name, vec_size, body, scale=30, out_range=20):
    prog = pkg.EvaProgram(name, vec_size=vec_size)
    with prog:
        body(pkg, prog)
    prog.set_output_ranges(out_range)
    prog.set_input_scales(scale)
    return prog


def _bin_op(op, enc1, enc2):
    def body(pkg, prog):
        pkg.Output("y", op(pkg.Input("a", enc1), pkg.Input("b", enc2)))
    return lambda pkg: _program(pkg, "BinOp", 64, body)


def _unary(op, enc):
    def body(pkg, prog):
        pkg.Output("y", op(pkg.Input("x", enc)))
    return lambda pkg: _program(pkg, "UnOp", 64, body)


def _rotation(op, rot):
    def body(pkg, prog):
        pkg.Output("y", op(pkg.Input("x"), rot))
    return lambda pkg: _program(pkg, "RotOp", 8, body)


def _mixed(enc1, enc2):
    def body(pkg, prog):
        x1, x2 = pkg.Input("x1", enc1), pkg.Input("x2", enc2)
        pkg.Output("y", pow(x2, 3) + x1 * x2)
    return lambda pkg: _program(pkg, "Mixed", 128, body)


def _high_inner_term_scale(pkg, prog):
    x1, x2 = pkg.Input("x1"), pkg.Input("x2")
    pkg.Output("y", x1 * x1 * x2)


def _transparent(pkg, prog):
    x = pkg.Input("x")
    pkg.Output("y", x - x + x * 0)


def _multiple_outputs(pkg, prog):
    x, y = pkg.Input("x"), pkg.Input("y")
    pkg.Output("a", x * y)
    pkg.Output("b", x + y)
    pkg.Output("c", x * x * y + y)


def _horizontal_sum(enc):
    def body(pkg, prog):
        hsum = _numeric(pkg).horizontal_sum
        if enc is None:
            pkg.Output("y", hsum([1 for _ in range(prog.vec_size)]))
        else:
            pkg.Output("y", hsum(pkg.Input("x", is_encrypted=enc)))
    return lambda pkg: _program(pkg, "HorizontalSum", 256, body, 33, 25)


def _numeric(pkg):
    from importlib import import_module
    return import_module(pkg.__name__ + ".std.numeric")


def _security_level(pkg, prog):
    x = pkg.Input("x")
    pkg.Output("y", 5 * x * x + 3 * x + x << 12 + 10)


def _minimum(pkg, prog):
    x = pkg.Input("x")
    pkg.Output("y", (x * x) * (x * x))


def build_sobel(pkg, h=90, w=90):
    """tests/test_large.py's build_sobel with the DSL of `pkg`."""
    import math
    prog = pkg.EvaProgram("sobel", vec_size=2 ** (math.ceil(math.log2(h * w))))
    with prog:
        image = pkg.Input("image")
        filt = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
        a1 = 2.2137874823876622
        a2 = -1.0984324107372518
        a3 = 0.17254603006834726
        Ix = Iy = None
        for i in range(3):
            for j in range(3):
                rotated = image << (i * w + j)
                horizontal = rotated * filt[i][j]
                vertical = rotated * filt[j][i]
                if Ix is None:
                    Ix, Iy = horizontal, vertical
                else:
                    Ix, Iy = Ix + horizontal, Iy + vertical
        x = Ix ** 2 + Iy ** 2
        pkg.Output("image", x * a1 + x ** 2 * a2 + x ** 3 * a3)
    prog.set_input_scales(45)
    prog.set_output_ranges(20)
    return prog


P_REGRESSION = 15


def _linreg(pkg):
    p = P_REGRESSION
    prog = pkg.EvaProgram("linear_regression", vec_size=512)
    with prog:
        x = [pkg.Input(f"x{i}") for i in range(p)]
        e = pkg.Input("e")
        b = [i * 0.732 for i in range(p)]
        y = e + 6.56
        for i in range(p):
            y += x[i] * b[i]
        pkg.Output("y", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    return prog


def _linreg_inputs(vec):
    inputs = {"e": [(vec - i) * 0.001 for i in range(vec)]}
    for i in range(P_REGRESSION):
        inputs[f"x{i}"] = [i * j * 0.0001 for j in range(vec)]
    return inputs


def _polyreg(pkg):
    prog = pkg.EvaProgram("polynomial_regression", vec_size=512)
    with prog:
        x = pkg.Input("x")
        e = pkg.Input("e")
        b = [i * 0.732 for i in range(4)]
        y = e + 6.56
        for i in range(4):
            x_i = x
            for _ in range(i):
                x_i = x_i * x
            y += x_i * b[i]
        pkg.Output("y", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    return prog


def _polyreg_inputs(vec):
    return {"x": [i * 0.001 for i in range(vec)],
            "e": [(vec - i) * 0.001 for i in range(vec)]}


def _multireg(pkg):
    p, k = P_REGRESSION, 2
    prog = pkg.EvaProgram("multivariate_regression", vec_size=512)
    with prog:
        x = [pkg.Input(f"x{i}") for i in range(p)]
        e = [pkg.Input(f"e{j}") for j in range(k)]
        b0 = [j * 0.56 for j in range(k)]
        b = [[k * i * 0.732 for i in range(p)] for j in range(k)]
        for j in range(k):
            y = e[j] + b0[j]
            for i in range(p):
                y += x[i] * b[j][i]
            pkg.Output(f"y{j}", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    return prog


def _multireg_inputs(vec):
    inputs = {}
    for i in range(P_REGRESSION):
        inputs[f"x{i}"] = [i * j * 0.0001 for j in range(vec)]
    for j in range(2):
        inputs[f"e{j}"] = [(vec - i) * j * 0.001 for i in range(vec)]
    return inputs


def _matrix():
    import operator
    cases = []
    for name, op in (("add", operator.add), ("sub", operator.sub),
                     ("mul", operator.mul)):
        for enc1 in (False, True):
            for enc2 in (False, True):
                cases.append(Case(f"bin_{name}_{enc1:d}{enc2:d}",
                                  _bin_op(op, enc1, enc2), group="he_ops"))
    for name, op in (("id", lambda x: x), ("neg", lambda x: -x),
                     ("cube", lambda x: x ** 3), ("const", lambda x: 42)):
        for enc in (False, True):
            cases.append(Case(f"unary_{name}_{enc:d}", _unary(op, enc),
                              group="he_ops"))
    for rot in range(-2, 2):
        cases.append(Case(f"rot_left_{rot}",
                          _rotation(lambda x, r: x << r, rot), group="he_ops"))
        cases.append(Case(f"rot_right_{rot}",
                          _rotation(lambda x, r: x >> r, rot), group="he_ops"))
    for enc1 in (False, True):
        for enc2 in (False, True):
            cases.append(Case(f"mixed_{enc1:d}{enc2:d}", _mixed(enc1, enc2),
                              group="he_ops"))
    cases += [
        Case("high_inner_term_scale",
             lambda pkg: _program(pkg, "HighInnerTermScale", 4,
                                  _high_inner_term_scale, 60),
             {"rescaler": "lazy_waterline"}),
        Case("transparent",
             lambda pkg: _program(pkg, "Transparent", 64, _transparent)),
        Case("multiple_outputs",
             lambda pkg: _program(pkg, "Multi", 32, _multiple_outputs)),
        Case("hsum_enc", _horizontal_sum(True)),
        Case("hsum_plain", _horizontal_sum(False)),
        Case("hsum_constant", _horizontal_sum(None)),
    ]
    for sec, quantum in (("128", "false"), ("192", "true"), ("256", "false")):
        cases.append(Case(
            f"security_{sec}_{quantum}",
            lambda pkg: _program(pkg, "SecurityLevel", 512, _security_level),
            {"security_level": sec, "quantum_safe": quantum}))
    cases.append(Case(
        "minimum_rescaler",
        lambda pkg: _program(pkg, "minr", 16, _minimum),
        {"rescaler": "minimum"}))
    for rescaler, balance in (("lazy_waterline", "true"),
                              ("always", "false")):
        cases.append(Case(f"sobel_{rescaler}", build_sobel,
                          {"rescaler": rescaler,
                           "balance_reductions": balance}, group="large"))
    for name, build, inputs in (("linear_regression", _linreg, _linreg_inputs),
                                ("polynomial_regression", _polyreg,
                                 _polyreg_inputs),
                                ("multivariate_regression", _multireg,
                                 _multireg_inputs)):
        cases.append(Case(name, build, inputs=inputs, group="large"))
    return {c.name: c for c in cases}


MATRIX = _matrix()
