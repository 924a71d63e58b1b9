"""Prompt enhancement (counterpart of ltx2_tpu/utils/prompt_enhancement.py):
the system prompts that ask Gemma-3 to expand a user's prompt, the chat
turns around them, the cleanup of the reply, and the i2v helpers.

The system prompts are the reference's text, verbatim: they are the data
that conditions the model. Generation is a callable handed in
(`generate_fn`), in the CLI `models/text_encoder/generation.generate_text`
on the Gemma that encodes the prompts. `resize_aspect_ratio_preserving`
resizes with the port's PIL-equal LANCZOS (utils/image_io.py), without
PIL.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ltx2_tpu_torch.utils.image_io import resize_lanczos

T2V_SYSTEM_PROMPT = """You are a highly skilled video production expert tasked with transforming simple user prompts into rich, cinematic video descriptions. Your goal is to take the user's basic idea and expand it into a detailed, visually compelling description that would guide a state-of-the-art AI video generator.

When enhancing prompts, consider:
1. Camera work: angles, movements (pan, tilt, zoom, tracking shots)
2. Lighting: natural, artificial, dramatic, soft, golden hour
3. Environment and setting details
4. Subject actions and movements
5. Color palette and visual mood
6. Temporal progression within the scene

Keep your response focused on visual description only. Do not include dialogue, sound effects, or music descriptions. Output only the enhanced prompt, nothing else."""

I2V_SYSTEM_PROMPT = """You are a highly skilled video production expert. Given an image and a user prompt, create a detailed video description that:
1. Accurately describes the key visual elements in the image
2. Incorporates the user's requested action or scene development
3. Adds cinematic details like camera movement, lighting changes, and temporal progression

Describe the video as a continuous scene starting from the provided image. Focus on visual elements only - no dialogue, sound effects, or music. Output only the enhanced prompt, nothing else."""



def clean_response(response: str) -> str:
    """Curly quotes straightened, leading list and quote markers and the
    surrounding whitespace stripped."""
    response = response.replace("\u201c", '"').replace("\u201d", '"')
    response = response.replace("\u2018", "'").replace("\u2019", "'")
    response = response.lstrip("-*:> ")
    return response.strip()


def resize_aspect_ratio_preserving(image: np.ndarray, long_side: int) -> np.ndarray:
    """uint8 (H, W, 3) or (H, W) resized so its long side is `long_side`,
    the other rounded, as PIL's LANCZOS resizes it (RGBA, which PIL resizes
    premultiplied, is refused)."""
    h, w = image.shape[:2]
    if image.ndim == 3 and image.shape[2] != 3:
        raise ValueError(f"resize_aspect_ratio_preserving takes RGB or grayscale images, not {image.shape[2]} "
                         "channels")
    if h >= w:
        new_h, new_w = long_side, max(1, round(w * long_side / h))
    else:
        new_h, new_w = max(1, round(h * long_side / w)), long_side
    img = torch.from_numpy(np.ascontiguousarray(image.astype(np.uint8)))
    out = resize_lanczos(img[..., None] if img.ndim == 2 else img, new_w, new_h).numpy()
    return out[..., 0] if image.ndim == 2 else out


def build_chat_prompt(system_prompt: str, user_prompt: str) -> str:
    """Gemma-3's turn format for the enhancement conversation."""
    return (
        f"<start_of_turn>user\n{system_prompt}\n\n{user_prompt}<end_of_turn>\n"
        f"<start_of_turn>model\n"
    )


def enhance_prompt(prompt: str, generate_fn: Callable[[str, int], str], system_prompt: str = T2V_SYSTEM_PROMPT,
                   max_tokens: int = 512) -> str:
    """The prompt expanded by `generate_fn(full_prompt, max_tokens)`, cleaned;
    the prompt itself when the reply cleans to nothing."""
    cleaned = clean_response(generate_fn(build_chat_prompt(system_prompt, prompt), max_tokens))
    return cleaned if cleaned else prompt


def create_i2v_chat_prompt(user_prompt: str, system_prompt: Optional[str] = None) -> str:
    """The i2v conversation: text only, an `[Image provided]` marker where
    the reference's image goes (the text model cannot take the pixels; the
    image conditions the video through the VAE), and no literal <bos> (the
    tokenizer adds the one BOS)."""
    system_prompt = system_prompt or I2V_SYSTEM_PROMPT
    return (
        f"<start_of_turn>user\n"
        f"{system_prompt}\n\n"
        f"[Image provided]\n"
        f"User prompt: {user_prompt}<end_of_turn>\n"
        f"<start_of_turn>model\n"
    )


def enhance_prompt_i2v(user_prompt: str, image_path: str, generate_fn: Callable[..., str], max_tokens: int = 256,
                       system_prompt: Optional[str] = None) -> str:
    """Image-to-video enhancement: the i2v conversation, sampled by
    `generate_fn(full_prompt, max_tokens, temperature=0.7, top_p=0.9)`, the
    reply after the last model turn cleaned. `image_path` is taken as the
    JAX function takes it and not read."""
    response = generate_fn(create_i2v_chat_prompt(user_prompt, system_prompt), max_tokens, temperature=0.7, top_p=0.9)
    if "<start_of_turn>model" in response:
        response = response.split("<start_of_turn>model")[-1]
    cleaned = clean_response(response)
    return cleaned if cleaned else user_prompt
