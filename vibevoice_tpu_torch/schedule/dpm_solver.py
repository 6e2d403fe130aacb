"""DPM-Solver++ multistep scheduler (port of vibevoice_tpu/schedule/dpm_solver.py).

``make_solver`` precomputes every per-step coefficient on the host (numpy,
float64, stored float32) exactly as the JAX package does, so its tables are
equal. ``sample`` runs the K-step solve as a Python loop over the uniform
rule

    m0 = a_conv * x + b_conv * raw_model_output
    x' = c_x * x + c_m0 * m0 + c_m1 * m1 + c_m2 * m2 + c_noise * z

in float32, with the reference's dynamic thresholding of m0 on request
(``_threshold_x0``; in x0 space, or through the epsilon <-> x0 round trip
for the dpmsolver / sde-dpmsolver tables). ``NoiseSchedule`` is the
train-time VP schedule (add_noise, get_velocity).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def _alpha_bar_fn(kind: str) -> Callable[[float], float]:
    if kind == "cosine":
        return lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    if kind == "exp":
        return lambda t: math.exp(t * -12.0)
    if kind == "cauchy":
        # SNR = mu + gamma * tan(pi * (0.5 - t) * 0.9); alpha_bar = 1 - 1/(e^snr + 1.1)
        return lambda t, gamma=1.0, mu=3.0: 1 - 1 / (
            math.exp(mu + gamma * math.tan(math.pi * (0.5 - t) * 0.9)) + 1.1
        )
    if kind == "laplace":
        return lambda t, mu=0.0, b=1.0: 1 - 1 / (
            math.exp(mu - b * math.copysign(1, 0.5 - t) * math.log(1 - 2 * abs(t - 0.5) * 0.98))
            + 1.02
        )
    raise ValueError(f"unknown alpha transform {kind}")


def betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999, kind: str = "cosine") -> np.ndarray:
    fn = _alpha_bar_fn(kind)
    i = np.arange(num_steps, dtype=np.float64)
    t1, t2 = i / num_steps, (i + 1) / num_steps
    return np.minimum(1 - np.array([fn(b) for b in t2]) / np.array([fn(a) for a in t1]), max_beta)


def make_betas(
    num_train_timesteps: int,
    beta_schedule: str,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
        )
    if beta_schedule in ("squaredcos_cap_v2", "cosine"):
        return betas_for_alpha_bar(num_train_timesteps, kind="cosine")
    if beta_schedule in ("exp", "cauchy", "laplace"):
        return betas_for_alpha_bar(num_train_timesteps, kind=beta_schedule)
    raise NotImplementedError(beta_schedule)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR rescale (reference :87-120; arXiv 2305.08891 alg. 1)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1 - alphas


@dataclass(frozen=True)
class NoiseSchedule:
    """Host-precomputed VP schedule tables, indexed by train timestep:
    alpha_t = sqrt(alphas_cumprod), sigma_t = sqrt(1 - alphas_cumprod), f32."""

    num_train_timesteps: int
    alpha_t: torch.Tensor  # (T,)
    sigma_t: torch.Tensor  # (T,)

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_schedule: str = "cosine",
        rescale_betas_zero_snr: bool = False,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
    ) -> "NoiseSchedule":
        betas = make_betas(num_train_timesteps, beta_schedule, beta_start, beta_end)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        ac = np.cumprod(1.0 - betas)
        if rescale_betas_zero_snr:
            ac[-1] = 2**-24
        return cls(
            num_train_timesteps=num_train_timesteps,
            alpha_t=torch.from_numpy(np.sqrt(ac).astype(np.float32)),
            sigma_t=torch.from_numpy(np.sqrt(1 - ac).astype(np.float32)),
        )

    def _coeffs(self, x0: torch.Tensor, t: torch.Tensor):
        shape = (-1,) + (1,) * (x0.ndim - 1)
        idx = t.to(device=x0.device, dtype=torch.long)
        a = self.alpha_t.to(x0.device)[idx].reshape(shape).to(x0.dtype)
        s = self.sigma_t.to(x0.device)[idx].reshape(shape).to(x0.dtype)
        return a, s

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x_t = alpha_t x0 + sigma_t eps."""
        a, s = self._coeffs(x0, t)
        return a * x0 + s * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v = alpha_t eps - sigma_t x0."""
        a, s = self._coeffs(x0, t)
        return a * noise - s * x0


class SolverCoeffs(NamedTuple):
    """Per-step coefficient table, (N,) float32 numpy arrays; see the module
    docstring for the rule. Working space is x0 for dpmsolver++ and epsilon
    for dpmsolver."""

    timesteps: np.ndarray
    a_conv: np.ndarray
    b_conv: np.ndarray
    c_x: np.ndarray
    c_m0: np.ndarray
    c_m1: np.ndarray
    c_m2: np.ndarray
    c_noise: np.ndarray
    alpha_s: np.ndarray
    sigma_s: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

def _inference_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int,
    timestep_spacing: str,
    last_timestep: Optional[int] = None,
    steps_offset: int = 0,
) -> np.ndarray:
    """Discrete model timesteps, descending (reference :357-382)."""
    last = num_train_timesteps if last_timestep is None else last_timestep
    if timestep_spacing == "linspace":
        return (
            np.linspace(0, last - 1, num_inference_steps + 1).round()[::-1][:-1].astype(np.int64)
        )
    if timestep_spacing == "leading":
        step_ratio = last // (num_inference_steps + 1)
        ts = (np.arange(0, num_inference_steps + 1) * step_ratio).round()[::-1][:-1].astype(
            np.int64
        )
        return ts + steps_offset
    if timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        return (np.arange(last, 0, -step_ratio).round() - 1).astype(np.int64)
    raise ValueError(timestep_spacing)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Fractional train-timestep for given sigmas by piecewise-log-linear
    interpolation (reference _sigma_to_t :460-481)."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, None]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return ((1 - w) * low_idx + w * high_idx).reshape(np.shape(sigma))


def _convert_to_karras(in_sigmas: np.ndarray, n: int, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigma spacing (reference :490-513)."""
    sigma_min, sigma_max = in_sigmas[-1], in_sigmas[0]
    ramp = np.linspace(0, 1, n)
    min_inv_rho, max_inv_rho = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def _convert_to_lu(in_lambdas: np.ndarray, n: int) -> np.ndarray:
    """Lu et al. (2022) uniform-lambda spacing, rho=1 (reference :515-526)."""
    lambda_min, lambda_max = in_lambdas[-1], in_lambdas[0]
    ramp = np.linspace(0, 1, n)
    return lambda_max + ramp * (lambda_min - lambda_max)


def make_solver(
    num_inference_steps: int,
    *,
    num_train_timesteps: int = 1000,
    beta_schedule: str = "cosine",
    prediction_type: str = "v_prediction",
    algorithm_type: str = "dpmsolver++",
    solver_order: int = 2,
    solver_type: str = "midpoint",
    lower_order_final: bool = True,
    euler_at_final: bool = False,
    final_sigmas_type: str = "zero",
    timestep_spacing: str = "linspace",
    rescale_betas_zero_snr: bool = False,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    trained_betas: Optional[np.ndarray] = None,
    use_karras_sigmas: bool = False,
    use_lu_lambdas: bool = False,
    lambda_min_clipped: float = -float("inf"),
    steps_offset: int = 0,
) -> SolverCoeffs:
    """Precompute the full solver table on host (float64).

    Accepts every scheduler config the reference documents
    (reference dpm_solver.py:203-227 and aliases :270-280)."""
    if algorithm_type == "deis":  # reference :271-272
        algorithm_type = "dpmsolver++"
    if solver_type in ("logrho", "bh1", "bh2"):  # reference :277-280
        solver_type = "midpoint"
    if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++", "dpmsolver", "sde-dpmsolver"):
        raise NotImplementedError(f"{algorithm_type} is not implemented")
    if solver_type not in ("midpoint", "heun"):
        raise NotImplementedError(f"{solver_type} is not implemented")
    if solver_order not in (1, 2, 3):
        raise ValueError("solver_order must be 1, 2 or 3 (reference :141-143)")
    plus = algorithm_type.endswith("++")
    sde = algorithm_type.startswith("sde")
    if sde and solver_order == 3:
        # the reference's third-order update has no SDE branch and crashes
        # with an unbound x_t (reference :893-909); fail loudly instead
        raise NotImplementedError("order-3 SDE updates do not exist in the reference")
    if not plus and final_sigmas_type == "zero":
        # reference :282-285
        raise ValueError(
            f"final_sigmas_type 'zero' is not supported for {algorithm_type}; use 'sigma_min'"
        )

    if trained_betas is not None:
        betas = np.asarray(trained_betas, np.float64)
    else:
        betas = make_betas(num_train_timesteps, beta_schedule, beta_start, beta_end)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    ac = np.cumprod(1.0 - betas)
    if rescale_betas_zero_snr:
        ac[-1] = 2**-24
    sigmas_full = np.sqrt((1 - ac) / ac)
    log_sigmas = np.log(sigmas_full)

    # lambda(t) = -log sigma_karras(t); clip its minimum (reference :352-355)
    lambda_full = -log_sigmas
    if np.isfinite(lambda_min_clipped):
        clipped_idx = int(np.searchsorted(lambda_full[::-1], lambda_min_clipped))
        last_timestep = num_train_timesteps - clipped_idx
    else:
        last_timestep = num_train_timesteps

    if use_karras_sigmas:
        sigmas = _convert_to_karras(sigmas_full[::-1], num_inference_steps)
        timesteps = _sigma_to_t(sigmas, log_sigmas).round()
    elif use_lu_lambdas:
        lambdas = _convert_to_lu(log_sigmas[::-1], num_inference_steps)
        sigmas = np.exp(lambdas)
        timesteps = _sigma_to_t(sigmas, log_sigmas).round()
    else:
        timesteps = _inference_timesteps(
            num_inference_steps, num_train_timesteps, timestep_spacing, last_timestep, steps_offset
        )
        sigmas = np.interp(timesteps, np.arange(len(sigmas_full)), sigmas_full)
    if final_sigmas_type == "zero":
        sigma_last = 0.0
    elif final_sigmas_type == "sigma_min":
        sigma_last = sigmas_full[0]
    else:
        raise ValueError(final_sigmas_type)
    sigmas = np.concatenate([sigmas, [sigma_last]])

    # 'trailing' spacing with a finite lambda_min_clipped can yield fewer
    # than num_inference_steps timesteps; the reference shrinks the step
    # count to match (set_timesteps :321-423) — mirror that instead of
    # indexing past the sigma table
    n = len(timesteps)

    def split(sigma):
        alpha = 1.0 / np.sqrt(sigma**2 + 1)
        return alpha, sigma * alpha

    def lam_of(alpha, sigma):
        return np.log(alpha) - np.log(sigma) if sigma > 0 else np.inf

    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        a_conv = np.zeros(n)
        b_conv = np.zeros(n)
        c_x = np.zeros(n)
        c_m = np.zeros((n, 3))
        c_noise = np.zeros(n)
        alpha_s_tab = np.zeros(n)
        sigma_s_tab = np.zeros(n)

        lower_order_nums = 0
        for i in range(n):
            alpha_s0, sigma_s0 = split(sigmas[i])
            alpha_t, sigma_t = split(sigmas[i + 1])
            alpha_s_tab[i], sigma_s_tab[i] = alpha_s0, sigma_s0

            # model output -> working space (reference :570-625)
            if plus:  # x0 space
                if prediction_type == "v_prediction":
                    a_conv[i], b_conv[i] = alpha_s0, -sigma_s0
                elif prediction_type == "epsilon":
                    a_conv[i], b_conv[i] = 1.0 / alpha_s0, -sigma_s0 / alpha_s0
                elif prediction_type == "sample":
                    a_conv[i], b_conv[i] = 0.0, 1.0
                else:
                    raise ValueError(prediction_type)
            else:  # epsilon space
                if prediction_type == "epsilon":
                    a_conv[i], b_conv[i] = 0.0, 1.0
                elif prediction_type == "sample":
                    a_conv[i], b_conv[i] = 1.0 / sigma_s0, -alpha_s0 / sigma_s0
                elif prediction_type == "v_prediction":
                    a_conv[i], b_conv[i] = sigma_s0, alpha_s0
                else:
                    raise ValueError(prediction_type)

            lam_t = lam_of(alpha_t, sigma_t)
            lam_s0 = lam_of(alpha_s0, sigma_s0)
            h = lam_t - lam_s0

            # order selection, exactly the reference step() logic (:977-1008)
            force_first = (i == n - 1) and (
                euler_at_final
                or (lower_order_final and n < 15)
                or final_sigmas_type == "zero"
            )
            force_second = (i == n - 2) and lower_order_final and n < 15
            if solver_order == 1 or lower_order_nums < 1 or force_first:
                order = 1
            elif solver_order == 2 or lower_order_nums < 2 or force_second:
                order = 2
            else:
                order = 3

            # per-step scalar multipliers A_x (on x), A_D[k] (on D0/D1/D2),
            # A_noise (reference :671-694 first, :755-818 second, :893-909 third)
            em_h, ep_h = np.exp(-h), np.exp(h)
            A_d = np.zeros(3)
            if plus and not sde:
                A_x = sigma_t / sigma_s0 if sigma_s0 > 0 else 0.0
                phi = em_h - 1.0
                A_d[0] = -alpha_t * phi
                if order == 2:
                    A_d[1] = (
                        -0.5 * alpha_t * phi
                        if solver_type == "midpoint"
                        else alpha_t * (phi / h + 1.0)
                    )
                elif order == 3:
                    A_d[1] = alpha_t * (phi / h + 1.0)
                    A_d[2] = -alpha_t * ((phi + h) / h**2 - 0.5)
                A_noise = 0.0
            elif plus and sde:
                A_x = (sigma_t / sigma_s0) * em_h if sigma_s0 > 0 else 0.0
                psi = 1.0 - em_h**2
                A_d[0] = alpha_t * psi
                if order == 2:
                    A_d[1] = (
                        0.5 * alpha_t * psi
                        if solver_type == "midpoint"
                        else alpha_t * (psi / (-2.0 * h) + 1.0)
                    )
                A_noise = sigma_t * np.sqrt(max(psi, 0.0))
            elif not plus and not sde:
                A_x = alpha_t / alpha_s0
                phi = ep_h - 1.0
                A_d[0] = -sigma_t * phi
                if order == 2:
                    A_d[1] = (
                        -0.5 * sigma_t * phi
                        if solver_type == "midpoint"
                        else -sigma_t * (phi / h - 1.0)
                    )
                elif order == 3:
                    A_d[1] = -sigma_t * (phi / h - 1.0)
                    A_d[2] = -sigma_t * ((phi - h) / h**2 - 0.5)
                A_noise = 0.0
            else:  # sde-dpmsolver
                A_x = alpha_t / alpha_s0
                phi = ep_h - 1.0
                A_d[0] = -2.0 * sigma_t * phi
                if order == 2:
                    A_d[1] = (
                        -sigma_t * phi
                        if solver_type == "midpoint"
                        else -2.0 * sigma_t * (phi / h - 1.0)
                    )
                A_noise = sigma_t * np.sqrt(max(ep_h**2 - 1.0, 0.0))

            # fold the D0/D1/D2 finite differences into (m0, m1, m2) weights
            # (reference D definitions :754-756 second order, :888-892 third)
            if order == 1:
                c_m[i] = A_d[0], 0.0, 0.0
            else:
                alpha_s1, sigma_s1 = split(sigmas[i - 1])
                r0 = (lam_s0 - lam_of(alpha_s1, sigma_s1)) / h
                d10 = np.array([1.0 / r0, -1.0 / r0, 0.0])  # D1_0 = (m0-m1)/r0
                if order == 2:
                    c_m[i] = A_d[0] * np.array([1.0, 0.0, 0.0]) + A_d[1] * d10
                else:
                    alpha_s2, sigma_s2 = split(sigmas[i - 2])
                    r1 = (lam_of(alpha_s1, sigma_s1) - lam_of(alpha_s2, sigma_s2)) / h
                    d11 = np.array([0.0, 1.0 / r1, -1.0 / r1])  # D1_1 = (m1-m2)/r1
                    d1 = d10 + (r0 / (r0 + r1)) * (d10 - d11)
                    d2 = (d10 - d11) / (r0 + r1)
                    c_m[i] = A_d[0] * np.array([1.0, 0.0, 0.0]) + A_d[1] * d1 + A_d[2] * d2

            c_x[i] = A_x
            c_noise[i] = A_noise
            if lower_order_nums < solver_order:
                lower_order_nums += 1

    f32 = lambda x: np.nan_to_num(x).astype(np.float32)
    return SolverCoeffs(
        timesteps=timesteps.astype(np.float32),
        a_conv=f32(a_conv),
        b_conv=f32(b_conv),
        c_x=f32(c_x),
        c_m0=f32(c_m[:, 0]),
        c_m1=f32(c_m[:, 1]),
        c_m2=f32(c_m[:, 2]),
        c_noise=f32(c_noise),
        alpha_s=f32(alpha_s_tab),
        sigma_s=f32(sigma_s_tab),
    )


def _threshold_x0(x0: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Dynamic thresholding (the reference's ``_threshold_sample``): each
    sample clamped to +/- its ``ratio`` quantile of |x0|, floored at 1 and
    capped at ``max_value``, then divided by it. torch.quantile's linear
    interpolation is jnp.quantile's default."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs(), ratio, dim=1).clamp(1.0, max_value)
    s = s.reshape((b,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def sample(
    coeffs: SolverCoeffs,
    denoise_fn: Callable,
    x_init: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    thresholding: bool = False,
    dynamic_thresholding_ratio: float = 0.995,
    sample_max_value: float = 1.0,
    eps_space: bool = False,
    extras=None,
) -> torch.Tensor:
    """Run the multistep solve in float32.

    denoise_fn(x, t) -> raw model output for a batch x, where t is the (B,)
    timestep; with ``extras`` (a list of per-step values) it is called as
    denoise_fn(x, t, extras[i]). ``noise`` (N, *x.shape) is the per-step SDE
    variance noise; without it, SDE tables draw from ``generator``.
    ``thresholding`` applies the reference's dynamic thresholding to each
    step's x0 estimate; ``eps_space=True`` for tables built for dpmsolver /
    sde-dpmsolver, whose m0 is an epsilon (converted to x0 and back)."""
    n = coeffs.num_steps
    if noise is None and generator is None and bool(np.any(coeffs.c_noise != 0.0)):
        raise ValueError("sde-dpmsolver(++) coefficients require `generator` or `noise`")
    x = x_init.float()
    m1 = torch.zeros_like(x)
    m2 = torch.zeros_like(x)
    for i in range(n):
        t = torch.full((x.shape[0],), float(coeffs.timesteps[i]), device=x.device)
        raw = (denoise_fn(x, t) if extras is None else denoise_fn(x, t, extras[i])).float()
        m0 = float(coeffs.a_conv[i]) * x + float(coeffs.b_conv[i]) * raw
        if thresholding:
            alpha, sigma = float(coeffs.alpha_s[i]), float(coeffs.sigma_s[i])
            if eps_space:
                x0 = _threshold_x0((x - sigma * m0) / alpha, dynamic_thresholding_ratio,
                                   sample_max_value)
                m0 = (x - alpha * x0) / sigma
            else:
                m0 = _threshold_x0(m0, dynamic_thresholding_ratio, sample_max_value)
        x_new = (float(coeffs.c_x[i]) * x + float(coeffs.c_m0[i]) * m0
                 + float(coeffs.c_m1[i]) * m1 + float(coeffs.c_m2[i]) * m2)
        if coeffs.c_noise[i] != 0.0:
            z = noise[i].float() if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
            x_new = x_new + float(coeffs.c_noise[i]) * z
        x, m1, m2 = x_new, m0, m1
    return x


def cfg_sample(
    coeffs: SolverCoeffs,
    head_fn: Callable,
    cond: torch.Tensor,
    uncond: torch.Tensor,
    cfg_scale: float,
    x_init: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    extras=None,
) -> torch.Tensor:
    """Classifier-free-guided solve: the head runs on the 2B batch
    [cond; uncond] and ``uncond + cfg_scale * (cond - uncond)`` drives one
    trajectory. With ``extras`` the head is called as head_fn(x2, t2, extra)."""
    both = torch.cat([cond, uncond], dim=0)

    def denoise(x, t, e=None):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        out = head_fn(x2, t2, both if extras is None else e)
        c, u = out.chunk(2, dim=0)
        return u + cfg_scale * (c - u)

    return sample(coeffs, denoise, x_init, generator=generator, noise=noise, extras=extras)
